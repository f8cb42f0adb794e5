"""The readings that a cell's limits are set from: the program's numbers and
the control's, seed by seed, for the cells of one configuration.

    python -m perfbench.readings --workloads d384-serve8,d384-bulk512 \\
        --seeds 11,12,13 --seconds 2 [--fault shuffled_assignment]

For each seed the configuration's index is built once; each cell gets a
short window at its own load, judged as a run judges it. The control is
the reference in the program's place at the precision just below the
configurations' float32 (TF32: ``reference.tf32``), judged by the same
numbers over the same queries. One JSON line a seed and cell, with whether
the program's numbers and the control's pass the cell's limits. The
benchmark's own runs never run the control.

``--fault`` plants a fault in the program's build before it runs (FAULTS),
so its readings are a broken quantizer's: rows in the wrong clusters, or a
k-means whose Lloyd steps return their state unchanged; or, in a cell with a
writer, a broken write path: an acknowledged batch left out of the index, or
an answer given an id of a batch whose add had not begun.

``--rescore-mode`` builds the index with the program's own rescore tier
switched (``off``: the int8 scores alone, the step below the two-level int8
residual that ``ivf-1m-d3072`` states), so the ``program`` readings are
that control's.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import time

import numpy as np
import torch

from . import harness, reference, spec, writer


def shuffled_assignment(setattr_=setattr) -> None:
    """Rows in the wrong clusters: the balanced assignment's answer
    permuted (each cluster keeps its size, so the layout's does too)."""
    from semcode_tpu_torch.index import ivf

    assign = ivf.balanced_assign

    def shuffled(*args, **kwargs):
        return np.random.default_rng(0).permutation(assign(*args, **kwargs))

    setattr_(ivf, "balanced_assign", shuffled)


def unmoved_kmeans(setattr_=setattr) -> None:
    """Lloyd steps that return their state unchanged: the centroids stay
    the k-means++ rows."""
    from semcode_tpu_torch.ops import kmeans

    setattr_(kmeans, "_lloyd", lambda x, init, iters, reseed: init.to(torch.float32))


def hidden_write(setattr_=setattr) -> None:
    """An acknowledged batch left out of the index: every 32nd add after
    the build (the 5th, the 37th, ...) hands out its ids and writes none of
    its rows."""
    from semcode_tpu_torch.index.ivf import IVFIndex

    add = IVFIndex.add
    adds = [0]

    def hidden(self, x, tags=None):
        if self._bulk or not self.is_trained:
            return add(self, x, tags)
        adds[0] += 1
        if adds[0] % 32 != 5:
            return add(self, x, tags)
        n = x.shape[0]
        tags = np.zeros(n, np.int32) if tags is None else np.asarray(tags, np.int32)
        return self._extend_meta(n, tags)

    setattr_(IVFIndex, "add", hidden)


def early_row(setattr_=setattr) -> None:
    """An answer given an id of a batch whose add had not begun: the last
    id of every answer replaced by one 4,096 rows past the last the index
    has handed out."""
    from semcode_tpu_torch.index.ivf import IVFIndex

    search = IVFIndex.search_device

    def early(self, q, k, **kw):
        s, i = search(self, q, k, **kw)
        i = i.clone()
        i[:, -1] = self.rows_allocated + 4096
        return s, i

    setattr_(IVFIndex, "search_device", early)


FAULTS = {f.__name__: f for f in (shuffled_assignment, unmoved_kmeans, hidden_write,
                                   early_row)}


def with_rescore_mode(cell: spec.Cell, mode: str) -> spec.Cell:
    """``cell`` with its index built at the program's rescore tier ``mode``
    (``off``: none, the int8 scores alone)."""
    cfg = dict(cell.config)
    cfg["index"] = {**cfg["index"], "rescore_mode": mode}
    cfg["rescore_tier"] = "none"
    return dataclasses.replace(cell, config=cfg)


def passes(numbers: dict, limits: dict) -> bool:
    return all(name in limits and value <= limits[name] for name, value in numbers.items())


def control_answers(ctrl, ans: harness.Answers) -> harness.Answers:
    """The control in the program's place: its answer for every query the
    window answered."""
    s, i = ctrl
    q = np.unique(ans.qidx)
    return harness.Answers(q, i.cpu().numpy()[q], s.cpu().numpy()[q], 0)


def control_writes(ctrl, ans: harness.Answers, check: writer.Check, pool: torch.Tensor,
                   n: int, k: int) -> harness.Answers:
    """The control in the program's place in a cell with a writer: for each
    answer of the window, the TF32 top-k over the corpus and the rows
    acknowledged before its call was sent, under the ids the index gave."""
    dev = pool.device
    w = writer.written(check.stream)
    a = writer.visibility(check.win, check.stream, ans.call)[0]
    qd = torch.from_numpy(ans.qidx).to(dev)
    s, g = reference.prefix_topk((ctrl[0][qd], ctrl[1][qd]), pool, qd, check.writes,
                                 torch.from_numpy(a).to(dev), k, base=n, control=True)
    g = g.cpu().numpy()
    ids = np.where(g < n, g, w.ids[np.clip(g - n, 0, max(len(w.ids) - 1, 0))])
    return harness.Answers(ans.qidx, ids, s.cpu().numpy(), 0, ans.call)


def readings(cells, seeds, seconds: float, device: torch.device):
    """Yield one record a seed and cell (all ``cells`` of one configuration
    and one pool size)."""
    base = cells[0]
    for c in cells[1:]:
        if c.config != base.config or c.traffic["pool"] != base.traffic["pool"]:
            raise ValueError("readings take cells of one configuration and pool")
    for seed in seeds:
        setup = harness.build(base, seed, device, seconds)
        if setup.writes is not None and len(cells) > 1:
            raise ValueError("readings take one cell with a writer at a time")
        wins = []
        for cell in cells:
            call = harness.search_call(setup.index, cell.traffic)
            harness.warm(call, harness.batches_of(setup.pool, int(cell.traffic["batch"])),
                         device)
            wins.append(harness.run_window(setup, cell.traffic, seconds, False, device))
        quantizer, back = harness.state_after(setup, base)
        pool, build_s, writes = setup.pool, setup.build_s, setup.writes
        del setup, call
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
        for cell, win in zip(cells, wins):
            k = int(cell.traffic["k"])
            rows, refs, probes, allowed, ctrl = harness.references(
                cell, seed, pool, quantizer, device, control=True)
            ans = harness.Answers.of(win, k)
            check = ctl_check = None
            if writes is None:
                ctl_ans = control_answers(ctrl, ans)
            else:
                check = writer.Check.of(writes, win, back, cell.config, seed, probes)
                ctl_check = dataclasses.replace(check, back={**back, "missed": 0})
                ctl_ans = control_writes(ctrl, ans, check, pool, rows.shape[0], k)
            prog = harness.judge(ans, refs, rows, pool, allowed, k, quantizer, check)
            ctl = harness.judge(ctl_ans, refs, rows, pool, allowed, k, quantizer, ctl_check)
            del rows
            e2e = harness.e2e_values(win, prog, 0.0, writes)
            del e2e["setup_s"]
            yield {"seed": seed, "workload": cell.name, "calls": len(win.batch_of),
                   "build_s": build_s, "e2e": e2e,
                   "writer": {**win.writer, **prog.detail} if writes is not None else None,
                   "program": {**prog.numbers, "recall_at_10": prog.recall_at_10,
                               "passes": passes(prog.numbers, cell.limits)},
                   "control": {**ctl.numbers, "recall_at_10": ctl.recall_at_10,
                               "passes": passes(ctl.numbers, cell.limits)}}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m perfbench.readings")
    p.add_argument("--workloads", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--fault", choices=sorted(FAULTS))
    p.add_argument("--rescore-mode", choices=("off",))
    args = p.parse_args(argv)
    if args.fault:
        FAULTS[args.fault]()
    cells = [spec.load(w) for w in args.workloads.split(",")]
    if args.rescore_mode:
        cells = [with_rescore_mode(c, args.rescore_mode) for c in cells]
    seeds = [int(s) for s in args.seeds.split(",")]
    device = torch.device("cuda", 0) if torch.cuda.is_available() else torch.device("cpu")
    t0 = time.perf_counter()
    for rec in readings(cells, seeds, args.seconds, device):
        rec["elapsed_s"] = time.perf_counter() - t0
        print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
