"""The last line of a run: its keys, its metrics, and no line without a card."""

import json
import time

import pytest
import torch

from perfbench import harness, spec
from perfbench.tests.tiny import make_root


@pytest.fixture(scope="module")
def cell(tmp_path_factory):
    return spec.load("tiny-serve8", make_root(tmp_path_factory.mktemp("line")))


def line_of(capsys, result):
    harness.print_result(result)
    out = capsys.readouterr().out.strip().splitlines()
    return json.loads(out[-1])


def test_untraced_line_has_the_contract_keys(cell, capsys):
    line = line_of(capsys, harness.run_cell(cell, 2**31 + 99, 0.5, False,
                                            torch.device("cpu"), time.perf_counter()))
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] > 0
    assert set(line["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    assert set(line["metrics"]) == {m["name"] for m in cell.end_to_end}
    for m in cell.end_to_end:
        assert line["metrics"][m["name"]]["unit"] == m["unit"]
        assert line["metrics"][m["name"]]["value"] > 0
    assert set(line["checks"]) == set(harness.CHECKS)
    for c in line["checks"].values():
        assert set(c) == {"value", "limit"}


def test_traced_line_carries_the_trace_keys(cell, capsys):
    line = line_of(capsys, harness.run_cell(cell, 5, 1.5, True, torch.device("cpu"),
                                            time.perf_counter()))
    assert list(line)[-2:] == ["breakdown", "checks"]
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    assert {"busy_s", "window_s"} <= set(line["device"])
    # a CPU run traces no device operation, so no per-layer metric is read
    assert line["metrics"] == {}
    assert line["correct"] is True


def test_no_card_no_line(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = harness.main(["--workload", "d384-serve8", "--seed", "1", "--seconds", "1",
                       "--trace", "0"])
    assert rc != 0
    assert capsys.readouterr().out == ""


def test_a_cell_without_limits_is_not_correct(tmp_path):
    root = make_root(tmp_path)
    (root / "perfbench" / "limits" / "tiny-serve8.json").unlink()
    cell = spec.load("tiny-serve8", root)
    result = harness.run_cell(cell, 3, 0.3, False, torch.device("cpu"), time.perf_counter())
    assert result["correct"] is False
    assert all(c["limit"] is None for n, c in result["checks"].items() if n != "failed")
