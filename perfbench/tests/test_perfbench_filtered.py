"""A mix restricted to one tag (d384-filtered1pct-512's bulk512-tag1) at a
size a test run holds: its answers are judged against the tagged rows
alone, and a search that ignores the filter is not correct."""

import time

import pytest
import torch

from perfbench import harness, spec
from perfbench.tests.tiny import TRAFFIC, make_root

TAGGED = {**TRAFFIC, "name": "tiny8-tag1", "allow_tags": [1]}


@pytest.fixture(scope="module")
def cell(tmp_path_factory):
    return spec.load("tiny-tag1", make_root(tmp_path_factory.mktemp("tag1"),
                                            workload="tiny-tag1", traffic=TAGGED))


def test_a_filtered_mix_is_correct(cell):
    result = harness.run(cell, 2**31 + 23, 0.3, False, torch.device("cpu"), time.perf_counter())
    assert result["correct"] is True, result["checks"]
    assert result["failed"] == 0


def test_answers_outside_the_tag_are_failed(cell, monkeypatch):
    from semcode_tpu_torch.index.ivf import IVFIndex

    search = IVFIndex.search_device

    def unfiltered(self, q, k, **kw):
        kw["allow_tags"] = None
        return search(self, q, k, **kw)

    monkeypatch.setattr(IVFIndex, "search_device", unfiltered)
    result = harness.run(cell, 2**31 + 29, 0.3, False, torch.device("cpu"), time.perf_counter())
    assert result["correct"] is False
    assert result["failed"] > 0
