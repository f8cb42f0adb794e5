"""One writer beside the readers, and the check of what each answer could see.

A mix may carry ``"writer"``::

    {"batch_rows": 128, "rows_per_s": 2048, "loop": "open", "rows": "mixture"}

The writer is one thread in an open loop, the only writer of the index, as
the store's indexer upserts under its write lock while readers go without
one. Batch ``j`` of a stretch is due at the stretch's start plus ``j *
batch_rows / rows_per_s``; the thread calls ``IVFIndex.add`` when a batch
is due, or at once when it is late, and records when the batch was due,
when its add began, when the add returned (the acknowledgement) and the ids
it returned. Its rows are drawn from the corpus's mixture, batch by batch
from the seed (``corpus.make_writes``), so the reference makes any batch
again. Set-up writes for ``SETUP_SECONDS`` at the mix's rate before the
window, so the index's growth past its build falls in set-up; the window's
stretch ends when the window closes, and the run waits for its last add.

There is one writer and its adds are in order, so the rows a call could
see are a prefix of the stream. For a call, ``a`` is the number of batches
acknowledged before it was sent, ``b`` the number begun before its answer
reached the host: the answer may hold rows of the corpus and of
``writes[:b]``, and is judged as covering the corpus and ``writes[:a]``,
less the pending tail that an add overlapping the call folded, which the
system documents that readers may briefly miss (``visibility``;
``harness.judge`` judges both kinds of cell). After the window the first and
last row of every acknowledged batch are searched as queries and must come
back first with their own ids (``read_back``).
"""

from __future__ import annotations

import dataclasses
import math
import threading
import time
import traceback
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np
import torch

from . import corpus

# set-up writes this long at the mix's rate before the window
SETUP_SECONDS = 1.0
# checks of a cell with a writer, beside harness.CHECKS
CHECKS = ("read_back_miss", "ack_unseen")
# an acknowledged row counts as unseen only where it outscores a returned
# row by more than this (f32 products summed in another order differ by less)
UNSEEN_MARGIN = 1e-4


@dataclass
class Batch:
    """One add of the stream: host-clock times, the ids it returned (None
    where it raised), and the rows of the index's pending tail after it."""

    due: float
    began: float = math.nan
    acked: float = math.nan
    ids: Optional[np.ndarray] = None
    error: Optional[str] = None
    pending: int = 0


@dataclass
class Stream:
    """The writer's rows, every batch a run may write, and its batches."""

    batch_rows: int
    rows_per_s: float
    rows: Optional[torch.Tensor]  # (batches * batch_rows, d) f32, on the device
    tags: Optional[np.ndarray]    # (batches * batch_rows,) int32, or None
    base: int                     # rows in the corpus
    batches: int
    done: List[Batch] = field(default_factory=list)
    window_from: int = 0          # first batch of the window
    failure: Optional[str] = None  # the thread itself failed

    @property
    def interval(self) -> float:
        return self.batch_rows / self.rows_per_s

    def write(self, index, t_start: float, t_end: float) -> None:
        """Add the batches due from ``t_start`` until ``t_end``, each when
        due or at once when late."""
        j = 0
        while True:
            due = t_start + j * self.interval
            if due >= t_end:
                return
            b = len(self.done)
            if b >= self.batches:
                raise RuntimeError(f"the stream holds {self.batches} batches")
            wait = due - time.perf_counter()
            if wait > 0:
                time.sleep(wait)
            rec = Batch(due)
            lo, hi = b * self.batch_rows, (b + 1) * self.batch_rows
            tags = self.tags[lo:hi] if self.tags is not None else None
            rec.began = time.perf_counter()
            try:
                rec.ids = np.asarray(index.add(self.rows[lo:hi], tags=tags),
                                     dtype=np.int64).copy()
            except Exception as exc:  # noqa: BLE001 - counted as failed, named on stderr
                rec.error = f"{type(exc).__name__}: {exc}"
            rec.acked = time.perf_counter()
            pend = getattr(index, "_pend", None)
            rec.pending = int(pend[3]) if pend is not None else 0
            self.done.append(rec)
            j += 1

    def start(self, index, t_start: float, t_end: float) -> threading.Thread:
        """The window's stretch on a thread of its own."""
        self.window_from = len(self.done)

        def run():
            try:
                self.write(index, t_start, t_end)
            except Exception:  # noqa: BLE001 - raised again by join()
                self.failure = traceback.format_exc()

        thread = threading.Thread(target=run, name="perfbench-writer")
        thread.start()
        return thread

    def window(self) -> List[Batch]:
        return self.done[self.window_from:]


def plan(cfg: dict, traffic: dict, seed: int, device: torch.device,
         seconds: float) -> Stream:
    """The mix's writer for a window of ``seconds``: rows for the set-up's
    batches and the window's, made on the device from the seed."""
    w = traffic["writer"]
    if w.get("loop", "open") != "open" or w.get("rows", "mixture") != "mixture":
        raise ValueError(f"unsupported writer {w}: an open loop of mixture rows")
    br, rate = int(w["batch_rows"]), float(w["rows_per_s"])
    batches = (math.ceil(SETUP_SECONDS * rate / br) + math.ceil(seconds * rate / br) + 1)
    base = int(cfg["rows"])
    tagged = int(cfg.get("tag_every", 0)) > 0
    return Stream(br, rate, corpus.make_writes(cfg, seed, batches, br, device),
                  corpus.row_tags(cfg, base, batches * br) if tagged else None,
                  base, batches)


def lateness_ms(stream: Stream) -> np.ndarray:
    """Acknowledged minus due, ms, of each batch due in the window."""
    return np.asarray([1e3 * (r.acked - r.due) for r in stream.window()])


def folding(stream: Stream) -> List[int]:
    """The batches whose add folded the pending tail into the index's
    clusters (the tail shrank)."""
    return [b for b in range(1, len(stream.done))
            if stream.done[b].pending < stream.done[b - 1].pending]


def summary(stream: Stream, t_end: float, moved: dict) -> dict:
    """What the writer did in the window, for the result line and stderr;
    ``moved``: the program's totals over the window (``program.delta``)."""
    win = stream.window()
    folds = sum(1 for b in folding(stream) if b >= stream.window_from)
    late = lateness_ms(stream)
    add = moved.get("spans", {}).get("ivf.add")
    return {"batches_due": len(win),
            "batches_begun_by_close": sum(1 for r in win if r.began < t_end),
            "rows_written": sum(len(r.ids) for r in win if r.ids is not None),
            "failed_batches": sum(1 for r in win if r.ids is None),
            "folds": folds,
            "late_ms_median": float(np.median(late)) if len(late) else None,
            "late_ms_mean": float(late.mean()) if len(late) else None,
            "late_ms_max": float(late.max()) if len(late) else None,
            "add_ms_mean": 1e3 * add["seconds"] / add["count"] if add else None,
            **{k: v for k, v in moved.get("counters", {}).items()
               if k.startswith(("ivf.route", "ivf.layout"))}}


# -- after the window ------------------------------------------------------------


def read_back(index, stream: Stream, traffic: dict) -> dict:
    """The first and last row of every acknowledged batch, searched as
    queries through the mix's call in batches of the mix's size (the last
    padded by repeating its first row): each must come back first with its
    own id. Returns {"asked", "missed"}."""
    from .harness import search_call

    pos, want = [], []
    for b, r in enumerate(stream.done):
        if r.ids is None or len(r.ids) != stream.batch_rows:
            continue
        pos += [b * stream.batch_rows, (b + 1) * stream.batch_rows - 1]
        want += [int(r.ids[0]), int(r.ids[-1])]
    call, batch = search_call(index, traffic), int(traffic["batch"])
    missed = 0
    for lo in range(0, len(pos), batch):
        sel = pos[lo:lo + batch]
        sel = sel + [sel[0]] * (batch - len(sel))
        q = stream.rows[torch.as_tensor(sel, device=stream.rows.device)]
        got = call(q)[1].numpy()[:, 0]
        missed += int((got[:len(want[lo:lo + batch])] != np.asarray(want[lo:lo + batch])).sum())
    return {"asked": len(want), "missed": missed}


@dataclass
class Written:
    """The stream as the index acknowledged it: each id's position."""

    pos_of: np.ndarray  # id -> position in the stream, -1 where none
    ids: np.ndarray     # position -> id, -1 where its batch was not acknowledged
    bad_batches: int    # batches that raised or returned unusable ids


def written(stream: Stream) -> Written:
    br, base = stream.batch_rows, stream.base
    n = len(stream.done) * br
    ids = np.full(n, -1, dtype=np.int64)
    bad = 0
    for b, r in enumerate(stream.done):
        got = r.ids
        if got is None or got.shape != (br,) or (got < base).any():
            bad += 1
            continue
        ids[b * br:(b + 1) * br] = got
    seen = ids[ids >= 0]
    if len(np.unique(seen)) != len(seen):  # an id handed out twice names no row
        ids[:], bad = -1, len(stream.done)
    pos_of = np.full(int(seen.max()) + 1 if len(seen) else 0, -1, dtype=np.int64)
    live = np.flatnonzero(ids >= 0)
    pos_of[ids[live]] = live
    return Written(pos_of, ids, bad)


def visibility(win, stream: Stream, calls: np.ndarray):
    """For each call number in ``calls``, in rows of the stream: ``a``, the
    rows acknowledged before the call was sent; ``b``, the rows whose add
    began before its answer was on the host; ``pend_from``, the first row
    still pending at the send; and ``[skip_lo, skip_hi)``, the pending tail
    that an add overlapping the call folded (empty where none did).

    A fold clears the tail before its rows reach the readers' snapshot, so
    a reader racing that add may miss them: the stale-but-consistent
    snapshot that ``_fold_pending`` documents (``semcode_tpu/index/ivf.py``,
    lines 752-755). Where a call overlaps two folds, the skip spans both
    tails, which adjoin."""
    br = stream.batch_rows
    acked = np.asarray([r.acked for r in stream.done])
    began = np.asarray([r.began for r in stream.done])
    sent = np.asarray(win.sent_s)[calls]
    back = sent + np.asarray(win.latency_s)[calls]
    a = np.searchsorted(acked, sent, side="left") * br
    b = np.searchsorted(began, back, side="right") * br
    pending = np.asarray([0] + [r.pending for r in stream.done])
    pend_from = a - pending[a // br]
    skip_lo = np.full(len(calls), np.iinfo(np.int64).max)
    skip_hi = np.zeros(len(calls), dtype=np.int64)
    for j in folding(stream):
        over = (sent <= stream.done[j].acked) & (back >= stream.done[j].began)
        skip_lo[over] = np.minimum(skip_lo[over], j * br - stream.done[j - 1].pending)
        skip_hi[over] = np.maximum(skip_hi[over], j * br)
    skip_lo = np.where(skip_hi > 0, skip_lo, 0)
    return a, b, pend_from, skip_lo, skip_hi


@dataclass
class Check:
    """What the check of a window with a writer needs beside its answers:
    the stream, the window's call times, the read-back, the stream's rows
    made again from the seed, and the reference's probe table."""

    stream: Stream
    win: object          # harness.Window
    back: dict           # read_back's {"asked", "missed"}
    writes: torch.Tensor  # (W, d) f32
    probes: torch.Tensor  # (pool, nlist) bool

    @classmethod
    def of(cls, stream: Stream, win, back: dict, cfg: dict, seed: int,
           probes: torch.Tensor) -> "Check":
        return cls(stream, win, back, corpus.make_writes(
            cfg, seed, len(stream.done), stream.batch_rows, probes.device), probes)


@dataclass
class Visible:
    """What each answer could see beside the corpus (``visible``): stream
    rows ``[0, a)`` less ``[skip_lo, skip_hi)`` it is judged as covering,
    rows ``[0, b)`` it may hold. Arrays run over the answers; with no writer
    every prefix is empty."""

    writes: torch.Tensor          # (W, d) f32
    pos_of: np.ndarray            # index id -> stream position, -1 where none
    a: np.ndarray
    b: np.ndarray
    pend_from: np.ndarray
    skip_lo: np.ndarray
    skip_hi: np.ndarray
    allow: Optional[np.ndarray]   # (W,) rows a tag filter allows, or None
    bad_rows: int = 0             # rows of the batches whose add raised

    def rows_of(self, ids: np.ndarray, n: int) -> np.ndarray:
        """Answer ids as reference rows: corpus rows as they are, a written
        row ``n`` plus its position, -1 for an id the stream never
        acknowledged."""
        out = np.where(ids < n, ids, -1)
        hi = (ids >= n) & (ids < len(self.pos_of))
        pos = self.pos_of[np.where(hi, ids, 0)] if len(self.pos_of) else out
        return np.where(hi & (pos >= 0), n + pos, out)

    def take(self, ok: np.ndarray) -> "Visible":
        return dataclasses.replace(self, a=self.a[ok], b=self.b[ok],
                                   pend_from=self.pend_from[ok],
                                   skip_lo=self.skip_lo[ok], skip_hi=self.skip_hi[ok])

    def unskipped(self, lo: int, hi: int) -> torch.Tensor:
        """(hi - lo, W) bool: the written rows answers ``lo:hi`` are judged
        as covering, within their prefix ``a`` (a fold's tail left out)."""
        dev = self.writes.device
        col = torch.arange(self.writes.shape[0], device=dev)[None, :]
        s_lo = torch.from_numpy(self.skip_lo[lo:hi]).to(dev)[:, None]
        s_hi = torch.from_numpy(self.skip_hi[lo:hi]).to(dev)[:, None]
        return (col < s_lo) | (col >= s_hi)


def visible(check: Optional[Check], ans, n: int, d: int, device: torch.device,
            allowed: Optional[np.ndarray]) -> Visible:
    """The stream's prefixes each of ``ans`` (``harness.Answers``) could
    see; with no writer (``check`` None), none."""
    m = len(ans.qidx)
    if check is None:
        zero = np.zeros(m, dtype=np.int64)
        return Visible(torch.zeros((0, d), device=device), np.zeros(0, np.int64),
                       zero, zero, zero, zero, zero,
                       np.zeros(0, bool) if allowed is not None else None)
    st = check.stream
    w = written(st)
    calls = ans.call if ans.call is not None else np.zeros(m, np.int64)
    a, b, pend_from, skip_lo, skip_hi = visibility(check.win, st, calls)
    allow = None
    if allowed is not None:
        n_w = len(st.done) * st.batch_rows
        allow = (st.tags[:n_w] != 0 if st.tags is not None else np.zeros(n_w, bool))
    return Visible(check.writes, w.pos_of, a, b, pend_from, skip_lo, skip_hi, allow,
                   w.bad_batches * st.batch_rows)


def slot_in(ids: np.ndarray, ref: np.ndarray, sub: int = 1 << 17) -> np.ndarray:
    """(M, k) bool: each slot's id is in its reference row."""
    out = np.empty(ids.shape, dtype=bool)
    for lo in range(0, len(ids), sub):
        a, r = ids[lo:lo + sub], ref[lo:lo + sub]
        out[lo:lo + sub] = (a[:, :, None] == r[:, None, :]).any(axis=2)
    return out


def unseen(vis: Visible, calls: np.ndarray, g: np.ndarray, n: int, ref_a: np.ndarray,
           score_a: np.ndarray, ivf_a: Optional[np.ndarray], ref_scores: np.ndarray,
           whole_prefix) -> tuple:
    """``ack_unseen``: rows of the stream that an answer is judged as
    covering (its prefix ``a``, less a folding tail) and does not hold: in
    the exact top-k over that prefix (and in its IVF top-k where the cell
    probes), outscoring a row it returned by more than UNSEEN_MARGIN. And,
    for the result's ``writer`` key, where these fall: the calls that missed
    such a row, the calls that overlapped a folding add, and
    ``fold_unseen``, the rows of folding tails that those calls missed by
    the same rule (the snapshot's documented staleness, not a check).
    ``whole_prefix(upto, sel)`` is the exact top-k of answers ``sel`` over
    stream rows ``[0, upto)``. Returns (ack_unseen, detail)."""
    least = ref_scores.min(axis=1) if len(g) else np.zeros(0, np.float32)
    need = (ref_a >= n) & ~slot_in(ref_a, g) & (score_a > least[:, None] + UNSEEN_MARGIN)
    if ivf_a is not None:
        need &= slot_in(ref_a, ivf_a)
    sel = np.flatnonzero(vis.skip_hi > vis.skip_lo)
    fold = 0
    if len(sel):
        s, i = (t.cpu().numpy() for t in whole_prefix(vis.a[sel], sel))
        pos = i - n
        tail = (pos >= vis.skip_lo[sel, None]) & (pos < vis.skip_hi[sel, None])
        fold = int((tail & ~slot_in(i, g[sel])
                    & (s > least[sel, None] + UNSEEN_MARGIN)).sum())
    return int(need.sum()), {
        "unseen_calls": int(len(np.unique(calls[need.any(axis=1)]))),
        "calls_during_folding_adds": int(len(np.unique(calls[sel]))),
        "fold_unseen": fold}


def placed_rows(rows: torch.Tensor, n: int, pos_of: np.ndarray, assign: np.ndarray):
    """The rows the index has placed in a cluster at the window's end (its
    pending tail left out), and their clusters: the quantizer's rows.
    ``rows`` holds the corpus and then the stream's rows; ``assign`` each
    index id's cluster, -1 where pending."""
    ids = np.flatnonzero(assign >= 0)
    pos = np.full(len(ids), -1, dtype=np.int64)
    hi = ids >= n
    inside = hi & (ids < len(pos_of))
    pos[inside] = pos_of[ids[inside]]
    keep = ~hi | (pos >= 0)  # an id the stream never acknowledged names no row
    g = np.where(hi, n + pos, ids)[keep]
    if len(g) == rows.shape[0] and np.array_equal(g, np.arange(len(g))):
        return rows, assign[ids[keep]]
    return rows[torch.from_numpy(g).to(rows.device)], assign[ids[keep]]


def main(argv=None) -> int:
    """``python -m perfbench.writer --workload <cell> --seed <n> --seconds
    <s>``: the rows per second the cell's writer sustains alone, with no
    readers: its batches added back to back, in a closed loop, into the
    cell's index built as a run builds it. One JSON line."""
    import argparse
    import json

    from . import harness, program, spec

    p = argparse.ArgumentParser(prog="python -m perfbench.writer")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=10.0)
    args = p.parse_args(argv)
    cell = spec.load(args.workload)
    device = torch.device("cuda", 0) if torch.cuda.is_available() else torch.device("cpu")
    setup = harness.build(cell, args.seed, device, args.seconds)
    index, stream = setup.index, setup.writes
    br = stream.batch_rows
    before = program.totals()
    n, pending, folds = 0, stream.done[-1].pending if stream.done else 0, 0
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < args.seconds:
        b = n % stream.batches
        index.add(stream.rows[b * br:(b + 1) * br],
                  tags=stream.tags[b * br:(b + 1) * br] if stream.tags is not None else None)
        pend = getattr(index, "_pend", None)
        now = int(pend[3]) if pend is not None else 0
        folds += now < pending
        pending, n = now, n + 1
    harness.sync(device)
    elapsed = time.perf_counter() - t0
    moved = program.delta(before, program.totals())
    print(json.dumps({"workload": cell.name, "seed": args.seed, "batches": n,
                      "rows_per_s": n * br / elapsed, "seconds": elapsed, "folds": folds,
                      "counters": moved.get("counters", {}),
                      "add": moved.get("spans", {}).get("ivf.add"),
                      "layout": moved.get("spans", {}).get("ivf.build.layout"),
                      "device": harness.device_info(device, 1)}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
