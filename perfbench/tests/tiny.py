"""A tiny cell for the harness's CPU tests: its files written into a copy
of the benchmark, so that nothing in the repository is edited."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

from perfbench import spec

CONFIG = {
    "name": "tiny", "source": "test", "rows": 6144, "dim": 128, "centers": 24,
    "noise": 0.35, "query_noise": 0.05, "tag_every": 10,
    "ingest_chunk_bytes": 1 << 20,
    "index": {"kind": "IVFIndex", "metric": "ip", "dtype": "int8", "nlist": 16,
              "nprobe": 4, "kmeans_iters": 4},
    "rescore_tier": "f32", "reduced": [],
}
TRAFFIC = {"name": "tiny8", "call": "IVFIndex.search_device", "loop": "closed",
           "clients": 1, "batch": 8, "k": 10, "mode": "auto", "nprobe": None,
           "allow_tags": None, "pool": 64}
LIMITS = {"failed": 0, "score_err": 1e-5, "miss_share": 0.01, "recall_miss": 0.05,
          "assign_off_nearest": 0.2, "assign_far": 0.05, "centroid_excess": 0.1}


def make_root(tmp: Path, workload: str = "tiny-serve8", traffic: dict = TRAFFIC,
              limits: dict = LIMITS) -> Path:
    """A copy of BENCHMARK.json and perfbench/ under ``tmp`` with the tiny
    configuration, ``traffic`` and the cell ``workload`` added as new files
    and entries."""
    root = tmp / "bench"
    shutil.copytree(spec.PACKAGE, root / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads((spec.ROOT / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "tiny", "source": "test",
                             "file": "perfbench/configs/tiny.json",
                             "reduced": [], "why": "CPU tests"})
    bench["workloads"].append({"name": workload, "config": "tiny",
                               "traffic": traffic["name"], "chips": 1, "why": "CPU tests"})
    # reported where the d384 serve cell's metrics are
    for m in bench["end_to_end"]:
        if "d384-serve8" in m.get("workloads", ()):
            m["workloads"].append(workload)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    (root / "perfbench" / "configs" / "tiny.json").write_text(json.dumps(CONFIG))
    (root / "perfbench" / "traffic" / f"{traffic['name']}.json").write_text(json.dumps(traffic))
    (root / "perfbench" / "limits" / f"{workload}.json").write_text(
        json.dumps({"limits": limits}))
    return root
