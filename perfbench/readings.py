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
k-means whose Lloyd steps return their state unchanged.

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

from . import harness, spec


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


FAULTS = {f.__name__: f for f in (shuffled_assignment, unmoved_kmeans)}


def with_rescore_mode(cell: spec.Cell, mode: str) -> spec.Cell:
    """``cell`` with its index built at the program's rescore tier ``mode``
    (``off``: none, the int8 scores alone)."""
    cfg = dict(cell.config)
    cfg["index"] = {**cfg["index"], "rescore_mode": mode}
    cfg["rescore_tier"] = "none"
    return dataclasses.replace(cell, config=cfg)


def passes(numbers: dict, limits: dict) -> bool:
    return all(name in limits and numbers[name] <= limits[name]
               for name in harness.CHECKS)


def control_answers(ctrl, ans: harness.Answers) -> harness.Answers:
    """The control in the program's place: its answer for every query the
    window answered."""
    s, i = ctrl
    q = np.unique(ans.qidx)
    return harness.Answers(q, i.cpu().numpy()[q], s.cpu().numpy()[q], 0)


def readings(cells, seeds, seconds: float, device: torch.device):
    """Yield one record a seed and cell (all ``cells`` of one configuration
    and one pool size)."""
    base = cells[0]
    for c in cells[1:]:
        if c.config != base.config or c.traffic["pool"] != base.traffic["pool"]:
            raise ValueError("readings take cells of one configuration and pool")
    for seed in seeds:
        setup = harness.build(base, seed, device)
        wins = []
        for cell in cells:
            call = harness.search_call(setup.index, cell.traffic)
            harness.warm(call, harness.batches_of(setup.pool, int(cell.traffic["batch"])),
                         device)
            wins.append(harness.run_window(setup, cell.traffic, seconds, False, device))
        quantizer = harness.state_of(setup.index, int(base.config["rows"]))
        pool, build_s = setup.pool, setup.build_s
        del setup, call
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
        for cell, win in zip(cells, wins):
            k = int(cell.traffic["k"])
            rows, refs, _, allowed, ctrl = harness.references(
                cell, seed, pool, quantizer, device, control=True)
            ans = harness.Answers.of(win, k)
            prog = harness.judge(ans, refs, rows, pool, allowed, k, quantizer)
            ctl = harness.judge(control_answers(ctrl, ans), refs, rows, pool,
                                allowed, k, quantizer)
            del rows
            yield {"seed": seed, "workload": cell.name, "calls": len(win.batch_of),
                   "build_s": build_s,
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
