"""``roofline.py`` against bytes and operations worked out by hand for the
four cells' shapes."""

import json

import pytest

from perfbench import roofline, spec


def config(name):
    return json.loads((spec.PACKAGE / "configs" / f"{name}.json").read_text())


# (config, batch, nprobe, probed clusters, bytes, int8 operations), by hand:
# centroids 1024 d 4 + queries Q d 4 + probed (1e6 / 1024) d + Q 10 rescore
# row (f32: 4 d; residual: d + 4) + Q 10 12; ops 2 Q (1024 + nprobe 1e6 / 1024) d
CASES = [
    ("ivf-1m-d384", 8, 32, 226, 1_572_864 + 12_288 + 84_750_000 + 122_880 + 960,
     198_291_456),
    ("ivf-1m-d3072", 8, 16, 120, 12_582_912 + 98_304 + 360_000_000 + 246_080 + 960,
     818_331_648),
    ("ivf-1m-d384", 512, 32, 1024, 1_572_864 + 786_432 + 384_000_000 + 7_864_320 + 61_440,
     12_690_653_184),
    ("ivf-1m-d3072", 256, 16, 1024,
     12_582_912 + 3_145_728 + 3_072_000_000 + 7_874_560 + 30_720, 26_186_612_736),
]


@pytest.mark.parametrize("name,q,nprobe,probed,nbytes,ops", CASES)
def test_bytes_and_operations(name, q, nprobe, probed, nbytes, ops):
    cfg = config(name)
    assert cfg["index"]["nprobe"] == nprobe
    assert roofline.search_bytes(cfg, q, 10, probed) == pytest.approx(nbytes, rel=1e-12)
    assert roofline.search_ops(cfg, q, nprobe) == pytest.approx(ops, rel=1e-12)
    # every cell is bound by bytes at these shapes
    assert roofline.search_seconds(cfg, q, 10, nprobe, probed) == pytest.approx(
        nbytes / 3.35e12, rel=1e-12)
