"""The per-layer p95 of a traced run (``readers.untraced_p95_ms``), and
every cell's per-layer metrics moving an end-to-end metric it reports."""

import json
import math
import time

import numpy as np
import pytest
import torch

from perfbench import harness, readers, spec
from perfbench.tests.tiny import make_root

NAME = "p95_ms.d3072-serve8"


class Ctx:
    def __init__(self, latency_s, traced):
        self.latency_s = latency_s
        self.trace = type("T", (), {"calls": traced})()


def test_the_traced_calls_are_left_out():
    lat = [0.001 * (1 + i) for i in range(100)]
    slow = [9.0] * 10
    ctx = Ctx(lat[:40] + slow + lat[40:], list(range(40, 50)))
    assert readers.untraced_p95_ms(ctx) == pytest.approx(np.percentile(lat, 95) * 1e3)
    assert readers.untraced_p95_ms(Ctx(slow, list(range(10)))) is None


def test_every_cells_layers_move_what_it_reports():
    bench = json.loads((spec.ROOT / "BENCHMARK.json").read_text())
    for w in bench["workloads"]:
        cell = spec.load(w["name"])
        reported = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in reported and len(reported) >= 2, w["name"]
        assert cell.per_layer, w["name"]
        for m in cell.per_layer:
            assert m["moves"] in reported, (w["name"], m["name"])
    d3072 = spec.load("d3072-serve8")
    assert "p95_ms.serve" not in {m["name"] for m in d3072.end_to_end}
    assert NAME in {m["name"] for m in d3072.per_layer}


def test_traced_tiny_line_carries_the_untraced_p95(tmp_path):
    root = make_root(tmp_path)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    for m in bench["per_layer"]:
        if m["name"] == NAME:
            m["workloads"].append("tiny-serve8")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = spec.load("tiny-serve8", root)
    assert [m["name"] for m in cell.per_layer] == [NAME]
    result = harness.run_cell(cell, 2**31 + 13, 1.5, True, torch.device("cpu"),
                              time.perf_counter())
    assert result["correct"] is True
    value = result["metrics"][NAME]["value"]
    assert math.isfinite(value) and value > 0
    assert result["metrics"][NAME]["unit"] == "ms"
