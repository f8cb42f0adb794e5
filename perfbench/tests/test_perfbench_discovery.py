"""A configuration, a mix and a per-layer metric added as new files and
entries are found by name, with no existing file edited."""

import hashlib
import json
import time

import torch

from perfbench import harness, spec
from perfbench.tests.tiny import make_root

READER = '''
def read(ctx):
    return float(len(ctx.trace.spans)) or None
'''


def digests(base):
    return {p.relative_to(base): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in base.rglob("*") if p.is_file() and "__pycache__" not in p.parts
            and "tests" not in p.relative_to(base).parts}


def test_new_files_and_entries_are_found(tmp_path):
    before = digests(spec.PACKAGE)
    root = make_root(tmp_path)
    (root / "perfbench" / "metrics" / "traced_calls.tiny.py").write_text(READER)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["per_layer"].append({"name": "traced_calls.tiny", "unit": "calls",
                               "better": "higher", "source": "program_span",
                               "layer": "harness", "moves": "qps",
                               "workloads": ["tiny-serve8"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    # every file the benchmark had is as it was; BENCHMARK.json only grew
    after = digests(root / "perfbench")
    assert {p: after[p] for p in before} == before
    original = json.loads((spec.ROOT / "BENCHMARK.json").read_text())
    for key in ("configs", "workloads", "per_layer"):
        assert bench[key][:len(original[key])] == original[key]
    for grown, was in zip(bench["end_to_end"], original["end_to_end"]):
        cells = was.get("workloads", [])
        assert grown.get("workloads", [])[:len(cells)] == cells
        assert {k: v for k, v in grown.items() if k != "workloads"} == \
            {k: v for k, v in was.items() if k != "workloads"}

    cell = spec.load("tiny-serve8", root)
    assert cell.config["name"] == "tiny" and cell.traffic["name"] == "tiny8"
    assert [m["name"] for m in cell.per_layer] == ["traced_calls.tiny"]
    assert cell.limits["score_err"] > 0
    result = harness.run_cell(cell, 11, 1.5, True, torch.device("cpu"), time.perf_counter())
    assert result["metrics"]["traced_calls.tiny"]["value"] >= 3
    assert result["metrics"]["traced_calls.tiny"]["unit"] == "calls"


def test_benchmark_cells_find_their_files():
    bench = json.loads((spec.ROOT / "BENCHMARK.json").read_text())
    for w in bench["workloads"]:
        cell = spec.load(w["name"])
        assert cell.config["name"] == w["config"]
        assert cell.traffic["name"] == w["traffic"]
        assert set(cell.limits) == set(harness.CHECKS)
        for m in cell.per_layer:
            assert callable(cell.reader(m["name"]))
