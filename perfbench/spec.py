"""Finding a cell's parts by name.

``BENCHMARK.json`` at the root lists the cells and metrics. Everything that
belongs to one configuration, traffic mix, per-layer metric or cell sits in
files of its own, found by the name the benchmark gives it:

- ``perfbench/configs/<config>.json``: the deployment (sizes, index, the
  guarantees), named by each entry of ``configs`` under ``file``;
- ``perfbench/traffic/<traffic>.json``: the mix's parameters;
- ``perfbench/metrics/<metric>.py``: a reader ``read(ctx)`` that returns
  the per-layer metric's value, or None where it finds nothing to read;
- ``perfbench/limits/<workload>.json``: the limit of each number that
  decides the cell's ``correct``;
- ``perfbench/calls/<call>.py``: the path that runs a mix whose ``"call"``
  is not the search's (``run_cell``, ``checks_of``); a model configuration
  names its program and plain reference by file (``model.py``).

A later change adds a cell, a configuration, a mix or a metric by adding
such files and entries; no file here needs an edit.
"""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Dict, List

PACKAGE = Path(__file__).resolve().parent
ROOT = PACKAGE.parent


@dataclass
class Cell:
    """One workload of the benchmark with everything it names."""

    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: List[dict]
    per_layer: List[dict]
    limits: Dict[str, float]
    root: Path

    def reader(self, metric: str) -> Callable:
        """The ``read`` function of ``metrics/<metric>.py``."""
        path = self.root / "perfbench" / "metrics" / f"{metric}.py"
        return load_file(path, f"perfbench_metric_{metric}").read


def load_file(path: Path, name: str):
    """The module of the Python file ``path``, loaded under ``name``."""
    spec = importlib.util.spec_from_file_location(name.replace(".", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def call_module(call: str, root: Path = ROOT):
    """The module of ``calls/<call>.py``."""
    return load_file(root / "perfbench" / "calls" / f"{call}.py", f"perfbench_call_{call}")


def _json(path: Path) -> dict:
    with open(path) as fh:
        return json.load(fh)


def _reported(metric: dict, cell: str, moved: set) -> bool:
    """A metric with ``workloads`` is reported in those cells; one without,
    in every cell that reports the end-to-end metric it moves (or, for an
    end-to-end metric, in every cell)."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return "moves" not in metric or metric["moves"] in moved


def load(workload: str, root: Path = ROOT) -> Cell:
    """The cell ``workload`` of ``root/BENCHMARK.json``."""
    bench = _json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json; "
                       f"have {sorted(cells)}")
    w = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    config = _json(root / configs[w["config"]]["file"])
    traffic = _json(root / "perfbench" / "traffic" / f"{w['traffic']}.json")
    e2e = [m for m in bench["end_to_end"] if _reported(m, workload, set())]
    moved = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"] if _reported(m, workload, moved)]
    limits_path = root / "perfbench" / "limits" / f"{workload}.json"
    limits = _json(limits_path)["limits"] if limits_path.exists() else {}
    return Cell(workload, int(w["chips"]), config, traffic, e2e, per_layer,
                {k: float(v) for k, v in limits.items()}, root)
