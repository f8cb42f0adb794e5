"""scan_topk (semcode_tpu_torch/ops/scan_top2.py): the exact route's int8
selection in one kernel, against the full-matrix route it replaces.

The plain torch version ``scan_topk_reference`` (what the wrapper runs on
CPU tensors) must equal ``index/scan._select_xla`` bit for bit: scores (as
bits, so -0 and +0 differ) and positions, ties and the masked tail
included, at the widths the exact route asks for. The route choice is a
pure function of what the call observes, and ``exact_scan`` on the CPU
keeps the matrix route; with the kernel's route forced it returns the same
answers. The CUDA kernels are compared with the plain version on the card
(tests/test_torch_cuda.py, chip_smoke.py); their geometry is checked here.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from semcode_tpu_torch.index import scan
from semcode_tpu_torch.index.scan import (
    _select_xla,
    exact_scan,
    quantize_queries_device,
    select_route,
)
from semcode_tpu_torch.ops import scan_top2
from semcode_tpu_torch.ops.scan_top2 import (
    CTA_QUERIES,
    MAX_WIDTH,
    SMEM_LIMIT,
    STAGE_BYTES,
    scan_topk,
    scan_topk_reference,
    topk_capacity,
    topk_geometry,
)
from semcode_tpu_torch.parallel.mesh import make_mesh
from semcode_tpu_torch.utils import tracing

D = 128


def _corpus(rows, n_live, dup, seed):
    """int8 rows quantized as the indexes store them, f32 norms, liveness;
    ``dup`` repeats a block of rows exactly (score ties); four rows with a
    zero scale score +0 or -0 by the sign of their product."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((rows, D)).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    if dup:
        x[rows // 2 : rows // 2 + 24] = x[:24]
        x[rows - 3 :] = x[7:10]
    sc = np.maximum(np.abs(x).max(axis=1), 1e-12) / 127.0
    vecs = np.clip(np.rint(x / sc[:, None]), -127, 127).astype(np.int8)
    sc = sc.astype(np.float32)
    zero = rng.choice(rows, 4, replace=False)
    sc[zero] = 0.0
    live = np.zeros(rows, bool)
    live[rng.choice(rows, n_live, replace=False)] = True
    live[zero] = True
    norms = np.sum(x * x, axis=1).astype(np.float32)
    tags = (np.arange(rows) % 3).astype(np.int32)
    return (torch.from_numpy(vecs), torch.from_numpy(sc), torch.from_numpy(live),
            torch.from_numpy(norms), torch.from_numpy(tags), x)


def _queries(nq, seed):
    rng = np.random.default_rng(seed + 1)
    q = rng.standard_normal((nq, D)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    return torch.from_numpy(q)


@pytest.mark.parametrize("width", [1, 10, 32, 64])
@pytest.mark.parametrize("nq", [1, 8, 70])
@pytest.mark.parametrize("rows", ["ragged", "sparse"])
@pytest.mark.parametrize("dup", [False, True])
@pytest.mark.parametrize("tagged", [False, True])
@pytest.mark.parametrize("metric", ["ip", "l2"])
def test_plain_version_equals_the_matrix_route(metric, tagged, dup, rows, nq, width):
    """``ragged``: 777 rows (not a multiple of the 256-row tile), ~95% live;
    ``sparse``: 300 rows with fewer live rows than the widest selection, so
    the tail holds the lowest masked rows at -3e38. The matrix route fetches
    up to 128 and keeps the first ``width``, as ``exact_scan`` slices it."""
    n_rows, n_live = (777, 740) if rows == "ragged" else (300, 5)
    seed = n_rows + nq + width + 7 * dup + 3 * tagged
    vecs, sc, live, norms, tags, _ = _corpus(n_rows, n_live, dup, seed)
    vld = live & (tags == 1) if tagged else live
    qq, qsc = quantize_queries_device(_queries(nq, seed))
    nrm = norms if metric == "l2" else None
    fetch = min(n_rows, 128)
    ms, mp = _select_xla(qq, qsc, vecs, norms, vld, sc, "int8", metric, fetch, False)
    ks, kp = scan_topk(vecs, sc, vld, nrm, qq, qsc, width)
    assert ks.shape == kp.shape == (nq, width)
    assert kp.dtype == torch.int64 and ks.dtype == torch.float32
    assert torch.equal(ks.view(torch.int32), ms[:, :width].view(torch.int32))
    assert torch.equal(kp, mp[:, :width])
    if rows == "sparse" and width > 10 and not tagged:
        # the live rows come first, then -3e38 at the lowest masked rows
        n_valid = int(vld.sum())
        assert (ks[:, n_valid:] == scan_top2.NEG).all()
        masked = torch.nonzero(~vld).flatten()[: width - n_valid]
        assert torch.equal(kp[:, n_valid:], masked.expand(nq, -1))


def test_plain_version_orders_negative_zero_below_positive_zero():
    vecs = torch.tensor([[1] * D, [-1] * D, [0] * D, [-1] * D], dtype=torch.int8)
    sc = torch.zeros(4)
    qq = torch.ones((1, D), dtype=torch.int8)
    qsc = torch.ones(1)
    s, p = scan_topk(vecs, sc, torch.ones(4, dtype=torch.bool), None, qq, qsc, 4)
    assert p.tolist() == [[0, 2, 1, 3]]  # +0 (rows 0, 2) before -0 (rows 1, 3)
    assert [str(v) for v in s[0].tolist()] == ["0.0", "0.0", "-0.0", "-0.0"]


@pytest.mark.parametrize("device,storage,score_dtype,width,dim,route", [
    ("cuda", "int8", "float32", 32, 384, "kernel"),
    ("cuda", "int8", "float32", 1, 3072, "kernel"),
    ("cuda", "int8", "float32", 64, 128, "kernel"),
    ("cuda", "int8", "float32", 65, 384, "matrix"),   # wider than the kernel
    ("cuda", "int8", "float32", 128, 384, "matrix"),  # the whole fetch
    ("cuda", "int8", "float32", 0, 384, "matrix"),
    ("cuda", "int8", "float16", 32, 384, "matrix"),   # the f16 score option
    ("cuda", "bfloat16", "float32", 32, 384, "matrix"),
    ("cuda", "float32", "float32", 32, 384, "matrix"),
    ("cuda", "int8", "float32", 32, 200, "matrix"),   # depth not in 128-byte chunks
    ("cpu", "int8", "float32", 32, 384, "matrix"),
    ("meta", "int8", "float32", 32, 384, "matrix"),
])
def test_select_route(device, storage, score_dtype, width, dim, route):
    assert select_route(device, storage, score_dtype, width, dim) == route


def _scan_operands(n_rows, seed, rescore):
    vecs, sc, live, norms, tags, x = _corpus(n_rows, n_rows - 40, True, seed)
    mirror = torch.from_numpy(x) if rescore == "f32" else None
    resid = rscl = None
    if rescore == "residual":
        back = vecs.float() * sc[:, None]
        r = torch.from_numpy(x) - back
        rscl = torch.clamp(r.abs().amax(dim=1), min=1e-12) / 127.0
        resid = torch.clamp(torch.round(r / rscl[:, None]), -127, 127).to(torch.int8)
    return vecs, norms, live, sc, mirror, tags, resid, rscl


@pytest.mark.parametrize("shards", [1, 2])
@pytest.mark.parametrize("case", ["f32", "residual", "none", "tagged", "l2", "wide"])
def test_exact_scan_on_the_cpu_keeps_its_answers(monkeypatch, case, shards):
    """exact_scan on the CPU takes the matrix route (counted per shard); with
    the route chosen as on a card (the kernel's plain version runs on the
    CPU) it returns the same scores and ids, bit for bit. ``wide`` gathers
    the whole fetch of 128, which keeps the matrix route on a card too."""
    rescore = {"f32": "f32", "residual": "residual", "l2": "f32", "wide": "f32"}.get(case)
    metric = "l2" if case == "l2" else "ip"
    vecs, norms, live, sc, mirror, tags, resid, rscl = _scan_operands(1000, 11, rescore)
    q = _queries(9, 11)
    mesh = make_mesh((shards,), ("data",), devices=["cpu"] * shards)
    kw = dict(k_out=10, tags=tags if case == "tagged" else None,
              allow=torch.tensor([1, -1], dtype=torch.int32) if case == "tagged" else None,
              resid=resid, rscales=rscl,
              # as the indexes resolve the auto width: max(3k, 32)
              rescore_width=-1 if case == "wide" else 32)
    fetch = 128 if rescore is not None else 10

    def run():
        return exact_scan(mesh, vecs, norms, live, sc, mirror, q, 10, fetch, metric,
                          "int8", **kw)

    before = tracing.snapshot()["counters"]
    s0, i0 = run()
    after = tracing.snapshot()["counters"]
    assert after.get("scan.select.matrix", 0) - before.get("scan.select.matrix", 0) == shards
    assert after.get("scan.select.kernel", 0) == before.get("scan.select.kernel", 0)
    monkeypatch.setattr(scan, "select_route",
                        lambda device, *rest: select_route("cuda", *rest))
    s1, i1 = run()
    taken = tracing.snapshot()["counters"].get("scan.select.kernel", 0) - after.get(
        "scan.select.kernel", 0)
    assert taken == (0 if case == "wide" else shards)
    assert torch.equal(s0.view(torch.int32), s1.view(torch.int32))
    assert torch.equal(i0, i1)


@pytest.mark.parametrize("width", [1, 10, 32, 33, 64])
@pytest.mark.parametrize("nq", [1, 8, 129, 256, 512, 700, 16896])
@pytest.mark.parametrize("rs,d", [(100, 128), (70001, 384), (1_000_000, 3072)])
def test_topk_geometry_fits_and_keeps_one_pair_a_cta(rs, d, nq, width):
    if width > rs:
        pytest.skip("no selection wider than the rows")
    geom = topk_geometry(rs, d, nq, 132, width)
    pairs = -(-nq // CTA_QUERIES)
    assert geom.n_query_pairs == pairs and geom.grid == geom.lists * pairs
    # item u = b + grid * j keeps pair u % pairs = b % pairs
    assert geom.grid % pairs == 0
    assert 1 <= geom.lists <= min(256, geom.n_row_tiles, 132 // pairs)
    assert geom.capacity == topk_capacity(width) >= width + 32
    assert geom.smem_bytes <= SMEM_LIMIT
    if d // 128 <= scan_top2.SHALLOW_CHUNKS and nq > 64:
        assert geom.stages == scan_top2.SHALLOW_STAGES
    else:  # as many stages as fit
        assert geom.smem_bytes + STAGE_BYTES > SMEM_LIMIT
        assert geom.stages >= (3 if width <= 32 else 2)
    assert geom.merge_smem_bytes == geom.merge_warps * geom.lists * width * 8
    assert 1 <= geom.merge_warps <= 8 and geom.merge_smem_bytes <= SMEM_LIMIT


@pytest.mark.parametrize("rs,d,nq,width,stages", [
    (1_000_000, 384, 512, 32, 2),     # d384-bulk512: the epilogue bounds it
    (1_000_000, 384, 8, 32, 3),       # d384-serve8: one query tile, bytes bound it
    (1_000_000, 384, 64, 32, 3),
    (1_000_000, 384, 65, 32, 2),      # a second tile of one query
    (1_000_000, 384, 512, 64, 2),     # wider buffers leave two stages anyway
    (1_000_000, 3072, 256, 32, 3),    # d3072-bulk256: 24 chunks, the rows' reads
    (1_000_000, 3072, 256, 64, 2),
    (1_000_000, 512, 512, 32, 3),     # four chunks: as many as fit
    (1_000_000, 128, 512, 32, 2),
])
def test_topk_geometry_stages_follow_the_shape(rs, d, nq, width, stages):
    """Stages at the cells' shapes and beside them: the smem budget of
    232,448 bytes holds the ring, the buffers and the rest."""
    geom = topk_geometry(rs, d, nq, 132, width)
    assert geom.stages == stages
    fixed = (scan_top2.SMEM_ALIGN + scan_top2.EPILOGUE_BYTES + scan_top2.MASK_BYTES
             + scan_top2.HIST_BYTES + scan_top2.TALLY_BYTES + scan_top2.STATE_BYTES
             + scan_top2.BARRIER_BYTES)
    assert geom.smem_bytes == fixed + CTA_QUERIES * geom.capacity * 8 + stages * STAGE_BYTES
    assert geom.smem_bytes <= SMEM_LIMIT == 232_448


def test_topk_geometry_rejects_what_the_kernel_cannot_run():
    for args in ((0, 128, 8, 132, 1), (100, 96, 8, 132, 1), (100, 128, 0, 132, 1),
                 (100, 128, 8, 132, 0), (100, 128, 8, 132, 65), (10, 128, 8, 132, 11),
                 (100, 128, 132 * 128 + 1, 132, 10)):
        with pytest.raises(ValueError):
            topk_geometry(*args)


def test_topk_constants_match_the_source():
    src = (Path(scan_top2.__file__).parent / "csrc" / "top2_scan.cu").read_text()
    const = {m.group(1): int(m.group(2))
             for m in re.finditer(r"constexpr int (k\w+) = (\d+);", src)}
    assert const["kMaxWidth"] == MAX_WIDTH
    assert const["kRoundRows"] == scan_top2.ROUND_ROWS
    assert const["kMaxLists"] == scan_top2.MAX_LISTS
    assert 8 * const["kBins"] * 4 == scan_top2.HIST_BYTES
    assert const["kEpiSlots"] * (const["kRowTile"] // 32) * 4 == scan_top2.MASK_BYTES
    assert const["kSmemLimit"] == SMEM_LIMIT and const["kChunk"] == scan_top2.DEPTH_CHUNK
    assert const["kBarrierBytes"] == scan_top2.BARRIER_BYTES
    assert const["kSmemAlign"] == scan_top2.SMEM_ALIGN
    assert 8 * 2 * 4 + 16 == scan_top2.TALLY_BYTES and "kTallyBytes = 8 * 2 * 4 + 16;" in src
    assert "kStateBytes = kCtaQueries * 16;" in src
    assert scan_top2.STATE_BYTES == CTA_QUERIES * 16
    # the entry point clears the bounds and the counters in one call
    assert "(nq + 2 + nq * lists) * sizeof(unsigned)" in src and scan_top2.COUNTERS == 2


def test_scan_topk_refuses_what_it_cannot_select():
    vecs, sc, live, norms, _, _ = _corpus(100, 90, False, 1)
    qq, qsc = quantize_queries_device(_queries(2, 1))
    with pytest.raises(ValueError):
        scan_topk(vecs, sc, live, None, qq, qsc, 65)
    with pytest.raises(TypeError):
        scan_topk(vecs.float(), sc, live, None, qq, qsc, 10)
    with pytest.raises(TypeError):
        scan_topk(vecs, sc, live.int(), None, qq, qsc, 10)
    s, p = scan_topk_reference(vecs, sc, live, norms, qq, qsc, 100)
    assert p.shape == (2, 100) and sorted(p[0].tolist()) == list(range(100))
