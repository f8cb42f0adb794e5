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

A mix with ``"writer"`` adds one writer thread beside the readers
(``writer.py``): set-up writes for a second before the window, the window's
writer runs with the readers, and each answer is judged against the rows it
could see, with the read-back of every acknowledged batch after the window.
A mix without it makes the same calls as before, and its answers are judged
with every prefix of the stream empty.

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

from . import corpus, kernels, program, reference, roofline, spec, writer
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
    writes: Optional[writer.Stream] = None


def build(cell: spec.Cell, seed: int, device: torch.device, seconds: float = 0.0) -> Setup:
    """The corpus and pool from ``seed``, then the index built from the
    corpus in ingest chunks (only the port's calls are timed). A mix with a
    writer makes its rows for a window of ``seconds`` too, and writes its
    set-up batches into the built index."""
    from semcode_tpu_torch.index.ivf import IVFIndex

    cfg, ix = cell.config, cell.config["index"]
    t0 = time.perf_counter()
    rows = corpus.make_rows(cfg, seed, device)
    writes = (writer.plan(cfg, cell.traffic, seed, device, seconds)
              if "writer" in cell.traffic else None)
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
    if writes is not None:
        t0 = time.perf_counter()
        writes.write(index, t0, t0 + writer.SETUP_SECONDS)
        sync(device)
        log(f"set-up writes: {len(writes.done)} batches in "
            f"{time.perf_counter() - t0:.3f} s; pending tail "
            f"{writes.done[-1].pending if writes.done else 0} rows")
    return Setup(index, pool, build_s, writes)


# -- the window ----------------------------------------------------------------


@dataclass
class Window:
    """What the window sent and got back. ``batch_of[c]`` is the pool batch
    of call ``c``; ``answers[c]`` its (scores, ids) on the host, or None
    where the call raised."""

    batch: int
    seconds: float = 0.0
    sent_s: List[float] = field(default_factory=list)
    latency_s: List[float] = field(default_factory=list)
    batch_of: List[int] = field(default_factory=list)
    answers: list = field(default_factory=list)
    errors: List[str] = field(default_factory=list)
    trace: Optional[Trace] = None
    lock: threading.Lock = field(default_factory=threading.Lock)
    writer: Optional[dict] = None  # with a writer: what it did (writer.summary)


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
            win.sent_s.append(t0)
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
    stream = setup.writes
    before = program.totals() if stream is not None else None
    t_start = time.perf_counter()
    t_end = t_start + seconds
    tracer = Tracer(t_start, seconds, device) if trace else None
    threads = [threading.Thread(target=client_loop,
                                args=(call, batches, c, clients, t_end, win))
               for c in range(1, clients)]
    writing = stream.start(setup.index, t_start, t_end) if stream is not None else None
    for t in threads:
        t.start()
    client_loop(call, batches, 0, clients, t_end, win, tracer)
    for t in threads:
        t.join()
    sync(device)
    win.seconds = time.perf_counter() - t_start
    if writing is not None:  # the readers' seconds end before the last add's wait
        writing.join()
        sync(device)
        if stream.failure is not None:
            raise RuntimeError(f"the writer failed:\n{stream.failure}")
        win.writer = writer.summary(stream, t_end, program.delta(before, program.totals()))
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
    call: Optional[np.ndarray] = None  # (M,) the call number of each

    @classmethod
    def of(cls, win: Window, k: int) -> "Answers":
        qidx, ids, scores, raised, calls = [], [], [], 0, []
        for c, (b, out) in enumerate(zip(win.batch_of, win.answers)):
            if out is None:
                raised += win.batch
                continue
            s, i = out
            calls.append(np.full(win.batch, c))
            qidx.append(np.arange(b * win.batch, (b + 1) * win.batch))
            ids.append(i.numpy().astype(np.int64).reshape(win.batch, -1))
            scores.append(s.numpy().astype(np.float32).reshape(win.batch, -1))
        if not qidx:
            return cls(np.zeros(0, np.int64), np.zeros((0, k), np.int64),
                       np.zeros((0, k), np.float32), raised, np.zeros(0, np.int64))
        return cls(np.concatenate(qidx), np.concatenate(ids),
                   np.concatenate(scores), raised, np.concatenate(calls))


def malformed(ids: np.ndarray, scores: np.ndarray, hi, k: int,
              allowed: Optional[np.ndarray]) -> np.ndarray:
    """(M,) bool: rows that are not k distinct ids in ``[0, hi)`` (one bound,
    or one a row), with finite scores in non-increasing order (and, under a
    filter, allowed)."""
    if ids.shape[1] != k:
        return np.ones(len(ids), dtype=bool)
    hi = np.broadcast_to(np.asarray(hi), (len(ids),))[:, None]
    bad = ~np.isfinite(scores).all(axis=1) | ((ids < 0) | (ids >= hi)).any(axis=1)
    bad |= (np.diff(scores, axis=1) > 0).any(axis=1)
    srt = np.sort(ids, axis=1)
    bad |= (srt[:, 1:] == srt[:, :-1]).any(axis=1)
    if allowed is not None:
        bad |= ~allowed[np.clip(ids, 0, len(allowed) - 1)].all(axis=1)
    return bad


@dataclass
class Judged:
    numbers: dict          # each of CHECKS
    recall_at_10: float
    detail: Optional[dict] = None  # with a writer: where the unseen rows fell


def judge(ans: Answers, refs: dict, rows: torch.Tensor, pool: torch.Tensor,
          allowed: Optional[np.ndarray], k: int, quantizer: dict,
          check: Optional[writer.Check] = None) -> Judged:
    """The window's answers against the reference's answer sets, and the
    index's quantizer against the rows it has placed.

    With a writer (``check``), each answer may hold rows of the corpus and
    of the writes begun before it returned, and is judged as covering the
    corpus and the writes acknowledged before its call was sent, less the
    pending tail an add was folding meanwhile (``writer.visibility``); the
    quantizer is judged over the rows placed at the window's end, and the
    read-back and ``ack_unseen`` join the numbers. With none, every prefix is
    empty. A slot counts for ``miss_share`` where it is in the exact top-k
    over either prefix; a row where the IVF top-k holds more of it, by that."""
    n, dev = rows.shape[0], rows.device
    vis = writer.visible(check, ans, n, rows.shape[1], dev, allowed)
    writes = vis.writes
    g = vis.rows_of(ans.ids, n)
    allowed_all = np.concatenate([allowed, vis.allow]) if allowed is not None else None
    bad = malformed(g, ans.scores, n + vis.b, k, allowed_all)
    ok = ~bad
    qidx, g, scores, vis = ans.qidx[ok], g[ok], ans.scores[ok], vis.take(ok)
    qd = torch.from_numpy(qidx).to(dev)
    allow_w = torch.from_numpy(vis.allow).to(dev) if vis.allow is not None else None

    def over_some(sel, upto, top=refs["exact"], member=None):
        q = qd[sel]
        return reference.prefix_topk((top[0][q], top[1][q]), pool, q, writes,
                                     torch.from_numpy(upto).to(dev), k, base=n,
                                     allow=allow_w, member=member)

    def over(top, upto, member=None):
        return over_some(slice(None), upto, top, member)

    top_a = over(refs["exact"], vis.a, vis.unskipped)
    ref_a = top_a[1].cpu().numpy()
    in_a = writer.slot_in(g, ref_a)
    got = (in_a | writer.slot_in(g, over(refs["exact"], vis.b)[1].cpu().numpy())).sum(axis=1)
    ivf_a = None
    if "ivf" in refs:
        ivf_a = over(refs["ivf"], vis.a, ivf_member(vis, qd, check, quantizer))[1].cpu().numpy()
        got = np.maximum(got, writer.slot_in(g, ivf_a).sum(axis=1))

    all_rows = torch.cat([rows, writes]) if writes.shape[0] else rows
    total = len(ans.qidx) + ans.raised
    score_err = 0.0
    ref_scores = np.zeros(g.shape, dtype=np.float32)
    if len(qidx):
        big = all_rows.shape[0]
        keys = (qidx[:, None] * big + g).ravel()
        uniq, inv = np.unique(keys, return_inverse=True)
        prod = reference.pair_scores(all_rows, pool, uniq // big, uniq % big)
        ref_scores = prod[inv].reshape(g.shape)
        score_err = float(np.abs(scores.ravel() - prod[inv]).max())
    # recall against the top-k the answer is judged as covering; a written
    # row outside it (begun later, or in a folding tail) that scores at or
    # above that top-k's last counts as a hit
    tenth = top_a[0][:, -1].cpu().numpy()
    pos = g - n
    outside = (pos >= vis.a[:, None]) | ((pos >= vis.skip_lo[:, None])
                                          & (pos < vis.skip_hi[:, None]))
    newer = (g >= n) & outside & (ref_scores >= tenth[:, None])
    recall = float((in_a | newer).sum() / (max(total, 1) * k))
    qrows, qassign = writer.placed_rows(all_rows, n, vis.pos_of, quantizer["assign"])
    numbers = {"failed": int(bad.sum()) + ans.raised + vis.bad_rows,
               "score_err": score_err,
               "miss_share": float(1.0 - got.sum() / (max(len(qidx), 1) * k))
               if len(qidx) else 1.0,
               "recall_miss": 1.0 - recall,
               **reference.quantizer_numbers(qrows, quantizer["centroids"], qassign)}
    detail = None
    if check is not None:
        numbers["read_back_miss"] = check.back["missed"] + (0 if check.back["asked"] else 1)
        numbers["ack_unseen"], detail = writer.unseen(
            vis, ans.call[ok], g, n, ref_a, top_a[0].cpu().numpy(), ivf_a, ref_scores,
            lambda upto, sel: over_some(torch.from_numpy(sel).to(dev), upto))
    return Judged(numbers=numbers, recall_at_10=recall, detail=detail)


def ivf_member(vis: writer.Visible, qd: torch.Tensor, check: Optional[writer.Check],
               quantizer: dict):
    """``reference.prefix_topk``'s ``member`` for the IVF answer set over
    the stream's rows: a row placed in a probed cluster, or still pending
    at the send (the pending tail is scanned whole), and not in a folding
    tail; None with no writer."""
    if check is None:
        return None
    dev = qd.device
    assign = np.full(vis.writes.shape[0], -1, dtype=np.int64)
    ids = writer.written(check.stream).ids
    fin = quantizer["assign"]
    inside = (ids >= 0) & (ids < len(fin))
    assign[inside] = fin[ids[inside]]
    aw = torch.from_numpy(assign).to(dev)
    pf = torch.from_numpy(vis.pend_from).to(dev)
    col = torch.arange(vis.writes.shape[0], device=dev)

    def member(lo, hi):
        placed = check.probes[qd[lo:hi]][:, aw.clamp(min=0)] & (aw >= 0)[None, :]
        return (placed | (col[None, :] >= pf[lo:hi, None])) & vis.unskipped(lo, hi)

    return member


def checks_of(traffic: dict) -> tuple:
    """The numbers that decide ``correct`` in a cell of this mix."""
    return CHECKS + writer.CHECKS if "writer" in traffic else CHECKS


def state_after(setup: Setup, cell: spec.Cell):
    """What the check needs of the index before it is freed: its quantizer
    and, with a writer, the read-back of every acknowledged batch (the
    writer's rows are then dropped: the reference makes them again)."""
    if setup.writes is None:
        return state_of(setup.index, int(cell.config["rows"])), None
    quantizer = state_of(setup.index, int(setup.index.rows_allocated))
    back = writer.read_back(setup.index, setup.writes, cell.traffic)
    setup.writes.rows = None
    return quantizer, back


def state_of(index, n: int) -> dict:
    """The index's quantizer, copied to the host before it is freed: the
    centroids and each row's cluster, judged against the rows and then
    defining the IVF answer set (with a writer, ``n`` is every row the
    index holds; a row still pending has cluster -1)."""
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
    assign = torch.from_numpy(quantizer["assign"][:rows.shape[0]]).to(device)
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


def e2e_values(win: Window, judged: Judged, setup_s: float,
               writes: Optional[writer.Stream] = None) -> dict:
    done = sum(win.batch for a in win.answers if a is not None)
    values = {
        "qps": done / win.seconds,
        "p95_ms": float(np.percentile(np.asarray(win.latency_s), 95) * 1e3),
        "recall_at_10": judged.recall_at_10,
        "setup_s": setup_s,
    }
    if writes is not None:
        values["write_p95_ms"] = float(np.percentile(writer.lateness_ms(writes), 95))
    return values


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
    setup = build(cell, seed, device, seconds)
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
    if win.writer is not None:
        log(f"writer: {win.writer}")
    quantizer, back = state_after(setup, cell)
    pool, build_s, writes = setup.pool, setup.build_s, setup.writes
    del setup, call
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    rows, refs, probes, allowed, _ = references(cell, seed, pool, quantizer, device)
    check = (writer.Check.of(writes, win, back, cell.config, seed, probes)
             if writes is not None else None)
    judged = judge(Answers.of(win, k), refs, rows, pool, allowed, k, quantizer, check)
    log(f"reference and check in {time.perf_counter() - t_ref:.3f} s")
    for err in sorted(set(win.errors))[:5]:
        log(f"a call raised: {err}")
    for err in sorted({r.error for r in writes.done if r.error} if writes else ())[:5]:
        log(f"an add raised: {err}")
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
        values = e2e_values(win, judged, setup_s, writes)
        metrics = {m["name"]: {"value": values[m["name"].split(".")[0]], "unit": m["unit"]}
                   for m in cell.end_to_end}
    result["metrics"] = metrics
    result["device"] = dev
    if trace and win.trace is not None:
        result["breakdown"] = win.trace.breakdown()
    if win.writer is not None:
        # the window's rates beside what the writer did: no bound holds them
        # yet (PERF.md), so they are not among the cell's metrics
        speeds = e2e_values(win, judged, setup_s, writes)
        result["writer"] = {**win.writer, **(judged.detail or {}),
                            **{k: speeds[k] for k in ("qps", "p95_ms", "write_p95_ms")}}
    checks = {name: {"value": judged.numbers[name], "limit": cell.limits.get(name)}
              for name in checks_of(cell.traffic)}
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
