"""The check's control and its faults at a size a test run holds: the
program passes the limits, the reference put in its place at TF32 fails
one, and a window whose answers are broken where they are produced, or
whose index was built with a broken quantizer, comes out not correct."""

import time

import pytest
import torch

from perfbench import harness, readings, spec
from perfbench.tests.tiny import LIMITS, make_root


@pytest.fixture(scope="module")
def cell(tmp_path_factory):
    return spec.load("tiny-serve8", make_root(tmp_path_factory.mktemp("control")))


def passes(numbers):
    return all(numbers[k] <= v for k, v in LIMITS.items())


def test_the_control_fails_where_the_program_passes(cell):
    recs = list(readings.readings([cell], [3, 2**31 + 4, 5], 0.3, torch.device("cpu")))
    assert len(recs) == 3
    for rec in recs:
        assert passes(rec["program"]), rec
        assert not passes(rec["control"]), rec


def test_tf32_rounds_to_ten_mantissa_bits():
    x = torch.tensor([1.0 + 2.0**-11, 1.0 + 3 * 2.0**-11, 1.0 + 2.0**-12], dtype=torch.float32)
    from perfbench.reference import tf32
    assert tf32(x).tolist() == [1.0, 1.0 + 2.0**-9, 1.0]


def altered(ids, scores, q):
    """An answer altered where it is produced: the last id of each row
    replaced by another row, its score kept."""
    ids = ids.clone()
    ids[:, -1] = (ids[:, -1] + 1) % 6144
    return scores, ids


def half_left_out(ids, scores, q):
    """Half of the batch left out: the second half answered with the
    first half's answers."""
    h = ids.shape[0] // 2
    return (torch.cat([scores[:h], scores[:h]])[: scores.shape[0]],
            torch.cat([ids[:h], ids[:h]])[: ids.shape[0]])


@pytest.mark.parametrize("fault", [altered, half_left_out])
def test_a_broken_timed_path_is_not_correct(cell, monkeypatch, fault):
    from semcode_tpu_torch.index.ivf import IVFIndex

    search = IVFIndex.search_device

    def broken(self, q, k, **kw):
        s, i = search(self, q, k, **kw)
        return fault(i, s, q)

    monkeypatch.setattr(IVFIndex, "search_device", broken)
    result = harness.run_cell(cell, 2**31 + 17, 0.3, False, torch.device("cpu"),
                              time.perf_counter())
    assert result["correct"] is False
    assert result["checks"]["score_err"]["value"] > LIMITS["score_err"] or \
        result["checks"]["miss_share"]["value"] > LIMITS["miss_share"]


@pytest.mark.parametrize("fault, number", [("shuffled_assignment", "assign_off_nearest"),
                                           ("unmoved_kmeans", "centroid_excess")])
def test_a_broken_quantizer_is_not_correct(cell, monkeypatch, fault, number):
    readings.FAULTS[fault](monkeypatch.setattr)
    result = harness.run_cell(cell, 2**31 + 19, 0.3, False, torch.device("cpu"),
                              time.perf_counter())
    assert result["correct"] is False
    assert result["checks"][number]["value"] > LIMITS[number], result["checks"]
    assert result["checks"]["centroid_excess"]["value"] > LIMITS["centroid_excess"]
