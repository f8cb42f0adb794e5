"""A writer beside the readers (``perfbench/writer.py``): a mix without one
runs as before; a sound run with one is correct; an acknowledged batch left
out, an answer holding a row whose add had not begun, or reads that skip
the pending tail, are not; the control fails where the program passes; and
the visibility of each call is the stream's prefix.

The writer's runs take the pending-tail path that ``d384-ingest8`` takes at
1M rows: a tiny index's mirror is far below the program's threshold, so the
tests lower it and the tail's size (a 256-row tail, folded every 4th add)."""

import json
import time

import numpy as np
import pytest
import torch

from perfbench import corpus, harness, readings, spec, writer
from perfbench.tests.tiny import (CONFIG, TRAFFIC, WRITE_LIMITS, WRITE_METRICS, WRITES,
                                  make_root)

_load = spec.load


@pytest.fixture(autouse=True)
def tail(monkeypatch):
    from semcode_tpu_torch.index.ivf import IVFIndex

    monkeypatch.setattr(IVFIndex, "PENDING_THRESHOLD_BYTES", 0)
    monkeypatch.setattr(IVFIndex, "PENDING_CAP", 256)


@pytest.fixture(scope="module")
def cell(tmp_path_factory):
    root = make_root(tmp_path_factory.mktemp("writer"), "tiny-ingest8", WRITES,
                     WRITE_LIMITS, WRITE_METRICS)
    return spec.load("tiny-ingest8", root)


def run(cell, seed, seconds=1.0, trace=False):
    return harness.run_cell(cell, seed, seconds, trace, torch.device("cpu"),
                            time.perf_counter())


def test_a_mix_without_a_writer_runs_as_before(tmp_path, monkeypatch):
    """The same pool and corpus bits as the formulas the harness had, no
    add in the window, and the same keys in the line."""
    cpu = torch.device("cpu")
    rows = corpus.make_rows(CONFIG, 2**31 + 3, cpu)
    centers = torch.randn(CONFIG["centers"], CONFIG["dim"],
                          generator=corpus.generator(cpu, corpus.derive(2**31 + 3, "centers")))
    gen = corpus.generator(cpu, corpus.derive(2**31 + 3, "rows", 0))
    assert torch.equal(rows[:corpus.chunk_rows(CONFIG)],
                       corpus.mixture_rows(gen, centers, corpus.chunk_rows(CONFIG), 0.35))
    gen = corpus.generator(cpu, corpus.derive(2**31 + 3, "queries"))
    assert torch.equal(corpus.make_pool(CONFIG, TRAFFIC, rows, 2**31 + 3),
                       corpus.queries_near(gen, rows, TRAFFIC["pool"], 0.05))
    assert np.array_equal(corpus.row_tags(CONFIG), np.arange(6144) % 10 == 0)

    from semcode_tpu_torch.index.ivf import IVFIndex

    adds, add = [], IVFIndex.add
    monkeypatch.setattr(IVFIndex, "add", lambda self, x, tags=None: (
        adds.append(self._bulk), add(self, x, tags))[1])
    plain = spec.load("tiny-serve8", make_root(tmp_path))
    result = run(plain, 2**31 + 41, 0.5)
    assert result["correct"] is True
    assert all(adds), "an add outside the build"
    assert list(result) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert list(result["checks"]) == list(harness.CHECKS)
    assert harness.checks_of(plain.traffic) == harness.CHECKS


def test_a_sound_run_with_a_writer_is_correct(cell):
    result = run(cell, 2**31 + 43, 1.0)
    assert result["correct"] is True, result["checks"]
    assert list(result["checks"]) == list(harness.CHECKS + writer.CHECKS)
    w = result["writer"]
    # the open loop kept its schedule: every batch due in the window written
    assert w["batches_due"] == 32 and w["rows_written"] == 32 * 64
    assert w["failed_batches"] == 0
    # the tail folded, and readers raced the folds; what they missed of a
    # folding tail is reported beside the checks, not counted in them
    assert w["folds"] >= 6 and w["calls_during_folding_adds"] > 0
    assert w["fold_unseen"] >= 0 and result["checks"]["ack_unseen"]["value"] == 0
    assert set(result["metrics"]) == {"recall_at_10", "setup_s"}
    assert all(m["value"] > 0 for m in result["metrics"].values())
    assert all(w[k] > 0 for k in ("qps", "p95_ms", "write_p95_ms", "add_ms_mean"))


def test_the_traced_line_carries_the_build_metrics(cell):
    result = run(cell, 2**31 + 47, 1.5, trace=True)
    assert result["correct"] is True
    assert set(result["metrics"]) == {"build_s", "kmeans_s", "layout_s"}
    assert all(m["value"] > 0 for m in result["metrics"].values())


def unmerged_tail(setattr_):
    """Reads that skip the pending tail: acknowledged rows unseen outside
    any fold."""
    from semcode_tpu_torch.index.ivf import IVFIndex

    setattr_(IVFIndex, "_merge_pending_into", lambda self, s, i, q, allow_tags=None: (s, i))


@pytest.mark.parametrize("fault, number", [("hidden_write", "read_back_miss"),
                                           ("early_row", "failed"),
                                           ("unmerged_tail", "ack_unseen")])
def test_a_broken_write_path_is_not_correct(cell, monkeypatch, fault, number):
    {**readings.FAULTS, "unmerged_tail": unmerged_tail}[fault](monkeypatch.setattr)
    result = run(cell, 2**31 + 53, 1.0)
    assert result["correct"] is False
    assert result["checks"][number]["value"] > WRITE_LIMITS[number], result["checks"]


def test_the_control_fails_where_the_program_passes(cell):
    recs = list(readings.readings([cell], [7, 2**31 + 8], 0.6, torch.device("cpu")))
    assert len(recs) == 2
    for rec in recs:
        assert rec["program"]["passes"] is True, rec
        assert rec["control"]["passes"] is False, rec
        assert rec["control"]["failed"] == 0 and rec["control"]["ack_unseen"] == 0


def test_each_call_sees_a_prefix_of_the_stream():
    """a: batches acknowledged before the send; b: batches begun before the
    answer; the pending tail from the last acknowledged add; the tail that
    an overlapping add folded (batch 2 folds batches 0-1)."""
    st = writer.Stream(4, 8.0, None, None, base=100, batches=3)
    for due, began, acked, pending in ((0.0, 0.0, 1.0, 4), (2.0, 2.0, 3.0, 8), (4.0, 4.5, 5.0, 4)):
        st.done.append(writer.Batch(due, began, acked, np.arange(4) + 100 + len(st.done) * 4,
                                    pending=pending))
    win = harness.Window(8, sent_s=[0.5, 1.0, 2.5, 4.2, 6.0],
                         latency_s=[0.1, 1.5, 0.1, 0.4, 0.1])
    a, b, pend_from, skip_lo, skip_hi = writer.visibility(win, st, np.arange(5))
    assert a.tolist() == [0, 0, 4, 8, 12]
    assert b.tolist() == [4, 8, 8, 12, 12]
    assert pend_from.tolist() == [0, 0, 0, 0, 8]
    assert writer.folding(st) == [2]
    assert skip_lo.tolist() == [0, 0, 0, 0, 0] and skip_hi.tolist() == [0, 0, 0, 8, 0]
    vis = writer.Visible(torch.zeros(12, 1), writer.written(st).pos_of, a, b, pend_from,
                         skip_lo, skip_hi, None)
    g = vis.rows_of(np.array([[3, 100, 111, 112, -1]]), 100)
    assert g.tolist() == [[3, 100, 111, -1, -1]]
    assert vis.unskipped(3, 5).tolist() == [[False] * 8 + [True] * 4, [True] * 12]


def test_one_judge_for_both_kinds_of_cell():
    """With no writer the judge's prefixes are empty: ids past the corpus are
    malformed, and the numbers are those of the answers against the corpus
    alone."""
    n, k = 64, 2
    rows = torch.nn.functional.normalize(torch.randn(n, 8, generator=torch.Generator().manual_seed(0)), dim=1)
    pool = rows[:4] * 1.0
    from perfbench import reference
    refs = reference.topk(rows, pool, k)
    s, i = refs["exact"]
    ids = i.numpy().copy()
    ids[3, 1] = n  # past the corpus
    ans = harness.Answers(np.arange(4), ids, s.numpy(), 0, np.arange(4))
    assign = np.zeros(n, np.int64)
    got = harness.judge(ans, refs, rows, pool, None, k,
                        {"centroids": rows.mean(0, keepdim=True).numpy(), "assign": assign})
    assert got.numbers["failed"] == 1 and got.numbers["miss_share"] == 0.0
    assert got.numbers["recall_miss"] == pytest.approx(0.25) and got.detail is None
    assert list(got.numbers) == list(harness.CHECKS)


def test_the_writer_alone_reports_its_rate(cell, monkeypatch, capsys):
    monkeypatch.setattr(spec, "load", lambda w, root=cell.root: _load(w, root))
    assert writer.main(["--workload", "tiny-ingest8", "--seed", "5", "--seconds", "0.3"]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["rows_per_s"] > 0 and line["batches"] > 0

