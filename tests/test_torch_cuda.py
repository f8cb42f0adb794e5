"""Kernels and device paths of semcode_tpu_torch on a CUDA card.

Every test needs an NVIDIA card and nvcc and skips without them. This file
imports nothing of JAX, so it runs on a card host that has no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

(``--noconftest``: the suite's conftest configures JAX's CPU mesh.)
Comparisons hold each kernel against its plain torch version on the same
card inputs: int8 bit-identical (scan_topk's scores as bits, so -0 and +0
differ) (dot_max, an integer maximum, in both
modes); bf16/f32 within rtol 1e-5 (f32 sums run in another order). Each
kernel's launch geometry is also held against what its entry point accepts.
The causal decoder's CUDA-graph decode step is held against its eager step
(bit for bit) and its float32 tokens against the CPU path's. One float32
step of each trainer (the encoder's, the LM's, the term table's) is held
against its CPU path. ``entry.dryrun_multichip(4)`` runs its sharded
training and index steps on the card.
"""

import numpy as np
import pytest
import torch

from semcode_tpu_torch.embeddings.hash_embedder import HashEmbeddings
from semcode_tpu_torch.index.flat import FlatIndex
from semcode_tpu_torch.ops import scan_top2
from semcode_tpu_torch.ops.scan_top2 import NEG, top2_scan, top2_scan_reference

pytestmark = pytest.mark.cuda


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _operands(storage, rs, d, nq, gen, device):
    x = torch.randn(rs, d, generator=gen, device=device)
    x = x / x.norm(dim=1, keepdim=True)
    q = torch.randn(nq, d, generator=gen, device=device)
    q = q / q.norm(dim=1, keepdim=True)
    add = torch.where(torch.rand(rs, generator=gen, device=device) < 0.05,
                      NEG, 0.0).float()
    if storage == "int8":
        sc = torch.clamp(x.abs().amax(1), min=1e-12) / 127.0
        vecs = torch.clamp(torch.round(x / sc[:, None]), -127, 127).to(torch.int8)
        qs = torch.clamp(q.abs().amax(1), min=1e-12) / 127.0
        qq = torch.clamp(torch.round(q / qs[:, None]), -127, 127).to(torch.int8)
        return vecs, sc, add, qq, qs
    dt = torch.bfloat16 if storage == "bfloat16" else torch.float32
    return (x.to(dt), torch.ones(rs, device=device), add, q.to(torch.bfloat16),
            torch.ones(nq, device=device))


@pytest.mark.parametrize("storage", ["int8", "bfloat16", "float32"])
@pytest.mark.parametrize("rs,d,nq", [(100, 128, 1), (1000, 384, 8), (70001, 384, 512)])
def test_top2_scan_matches_plain_version(cuda, storage, rs, d, nq):
    gen = torch.Generator(device=cuda).manual_seed(rs + d + nq)
    ops = _operands(storage, rs, d, nq, gen, cuda)
    before = scan_top2.top2_scan.launches
    bm, br = top2_scan(*ops)
    torch.cuda.synchronize()
    assert scan_top2.top2_scan.launches == before + 1
    rm, rr = top2_scan_reference(*ops)
    if storage == "int8":
        assert torch.equal(bm, rm) and torch.equal(br, rr)
    else:
        torch.testing.assert_close(bm, rm, rtol=1e-5, atol=1e-6)


def _tile_edge_operands(rs, d, nq, gen, device):
    """int8 operands with exact duplicates on both sides of the 128-row
    block boundary inside the first 256-row tile, a tie inside block 0, and
    all-dead blocks in the first and second half of later tiles."""
    vecs, sc, add, qq, qs = _operands("int8", rs, d, nq, gen, device)
    vecs[128:132] = vecs[124:128]
    sc[128:132] = sc[124:128]
    vecs[5] = vecs[77]
    sc[5] = sc[77]
    for lo in (256, 640):  # block 2 (first of tile 1), block 5 (second of tile 2)
        if rs > lo + 128:
            add[lo:lo + 128] = NEG
    return vecs, sc, add, qq, qs


@pytest.mark.parametrize("rs,d,nq", [
    (255, 384, 65),
    (256, 384, 1000),
    (257, 384, 65),
    (1023, 3072, 1000),
    (1024, 1024, 65),
    (1025, 3072, 8),
    (70001, 384, 1000),   # more work items than CTAs, rows shared by both consumers
    (40000, 3072, 512),   # more work items than CTAs, one row load per consumer
])
def test_top2_scan_int8_tile_edges(cuda, rs, d, nq):
    gen = torch.Generator(device=cuda).manual_seed(rs * 7 + d + nq)
    ops = _tile_edge_operands(rs, d, nq, gen, cuda)
    before = scan_top2.top2_scan.launches
    bm, br = top2_scan(*ops)
    torch.cuda.synchronize()
    assert scan_top2.top2_scan.launches == before + 1
    rm, rr = top2_scan_reference(*ops)
    assert torch.equal(bm, rm) and torch.equal(br, rr)


def _float_rows_agree(ops, bm, br, rm, rr):
    """bf16/f32 rows: scores within rtol 1e-5; first rows identical where a
    block's top-2 gap exceeds 1e-4; every pick scoring (plain arithmetic) as
    the plain version's pick; sentinel slots on the plain version's row."""
    torch.testing.assert_close(bm, rm, rtol=1e-5, atol=1e-6)
    nb = bm.shape[1] // 2
    gap = (rm[:, :nb] - rm[:, nb:]).abs() > 1e-4
    assert torch.equal(br[:, :nb][gap], rr[:, :nb][gap])
    vecs, mult, add, qq, qsc = ops
    rs = vecs.shape[0]
    raw = (qq.double() @ vecs.to(torch.bfloat16).double().T).float()
    plain = torch.full((qq.shape[0], nb * 128), NEG, device=vecs.device)
    plain[:, :rs] = raw * qsc[:, None] * mult[None, :] + add[None, :]
    dead = rm <= NEG
    assert torch.equal(br[dead], rr[dead])
    picked = torch.gather(plain, 1, br.long())
    torch.testing.assert_close(picked[~dead], rm[~dead], rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("storage", ["bfloat16", "float32"])
@pytest.mark.parametrize("rs,d,nq", [
    (255, 128, 65),
    (256, 384, 1000),
    (257, 1024, 65),      # a last block with one live row: sentinel runner-up
    (1023, 3072, 1000),   # one row load per consumer
    (1025, 1024, 8),
    (70001, 384, 1000),   # more work items than CTAs
    (40000, 3072, 512),
])
def test_top2_scan_float_tile_edges(cuda, storage, rs, d, nq):
    gen = torch.Generator(device=cuda).manual_seed(rs * 5 + d + nq)
    x, _, add, q, _ = _operands(storage, rs, d, nq, gen, cuda)
    x[128:132] = x[124:128]  # duplicates across the block boundary
    x[5] = x[77]
    for lo in (256, 640):
        if rs > lo + 128:
            add[lo:lo + 128] = NEG
    ops = (x, torch.ones(rs, device=cuda), add, q, torch.ones(nq, device=cuda))
    before = scan_top2.top2_scan.launches
    bm, br = top2_scan(*ops)
    torch.cuda.synchronize()
    assert scan_top2.top2_scan.launches == before + 1
    _float_rows_agree(ops, bm, br, *top2_scan_reference(*ops))


@pytest.mark.parametrize("storage", ["int8", "bfloat16", "float32"])
def test_top2_scan_geometry_is_what_the_library_accepts(cuda, storage):
    """scan_geometry's launch runs; one stage more, or other shared-memory
    bytes, is refused by the entry point (cudaErrorInvalidValue)."""
    rs, d, nq = 5000, 384, 100
    gen = torch.Generator(device=cuda).manual_seed(7)
    vecs, mult, add, qq, qsc = _operands(storage, rs, d, nq, gen, cuda)
    geom = scan_top2.scan_geometry(rs, d, nq, torch.cuda.get_device_properties(cuda)
                                   .multi_processor_count, storage)
    nb = -(-rs // 128)
    bmax = torch.empty((nq, 2 * nb), device=cuda)
    brow = torch.empty((nq, 2 * nb), dtype=torch.int32, device=cuda)
    lib = scan_top2._library.get()
    code = {"int8": 0, "bfloat16": 1, "float32": 2}[storage]

    def call(stages, smem):
        return lib.semcode_top2_scan(
            vecs.data_ptr(), mult.data_ptr(), add.data_ptr(), qq.data_ptr(),
            qsc.data_ptr(), bmax.data_ptr(), brow.data_ptr(), rs, d, nq, code,
            geom.grid, stages, smem, torch.cuda.current_stream().cuda_stream)

    assert call(geom.stages, geom.smem_bytes) == 0
    torch.cuda.synchronize()
    more = geom.smem_bytes + scan_top2.STAGE_BYTES
    assert call(geom.stages + 1, more) != 0
    assert call(geom.stages, geom.smem_bytes + 1024) != 0


def _topk_operands(rs, d, nq, live, gen, device):
    """int8 rows with exact duplicates (inside a tile, across a tile boundary
    and far apart), row norms and a liveness mask: each row live with
    probability ``live``, or by name: "equal" (every row the same row, so
    every score ties and every row of an item passes), "rising" (every row
    above all earlier ones, so each offer round cuts its buffers: cuts in
    consecutive rounds), "words" (95% live, with whole 32-row words masked:
    every other word of the first tiles and every third further on)."""
    vecs, sc, _, qq, qs = _operands("int8", rs, d, nq, gen, device)
    for dst, src, n in ((250, 0, 12), (rs // 2, 0, 64), (rs - 5, 3, 5)):
        n = max(0, min(n, rs - dst, rs - src))
        vecs[dst:dst + n] = vecs[src:src + n]
        sc[dst:dst + n] = sc[src:src + n]
    if live == "equal":
        vecs[:] = vecs[0]
        sc[:] = sc[0]
    elif live == "rising":
        # one direction, a scale rising with the row: for queries on that
        # side of it, each row scores above every earlier row
        vecs[:] = vecs[0]
        sc = sc[0] * (1.0 + torch.arange(rs, device=device, dtype=torch.float32) / rs)
        qq[: nq // 2] = vecs[0]
    norms = (vecs.float() * sc[:, None]).pow(2).sum(dim=1)
    share = live if isinstance(live, float) else 1.0 if live != "words" else 0.95
    valid = torch.rand(rs, generator=gen, device=device) < share
    if live == "words":
        words = torch.arange(rs, device=device) // 32
        valid &= ~(((words < 64) & (words % 2 == 0)) | (words % 3 == 1))
    return vecs, sc, valid, norms, qq, qs


@pytest.mark.parametrize("rs,d,nq,w,metric,live", [
    (100, 128, 1, 1, "ip", 0.95),
    (255, 384, 65, 10, "l2", 0.95),
    (257, 384, 129, 64, "ip", 0.95),
    (1000, 3072, 8, 33, "l2", 0.95),
    (70001, 384, 512, 32, "ip", 0.95),   # more items than CTAs, rows shared
    (40000, 3072, 256, 32, "ip", 0.95),  # one row load per consumer
    (30000, 384, 70, 32, "ip", 0.0003),  # fewer live rows than w: a masked tail
    (256, 384, 64, 32, "ip", 0.95),      # one row tile, one query tile
    (5000, 128, 3, 64, "ip", 0.95),
    (70001, 384, 700, 10, "l2", 0.95),   # query pairs past a multiple of the SMs' share
    (70001, 768, 8, 32, "ip", 0.95),
    (40000, 1024, 130, 20, "ip", 0.95),
    # the epilogue's edges: buffers that fill in every round, masked words,
    # second query tiles with one query or none, each width class
    (70001, 384, 512, 32, "ip", "equal"),    # every row of an item passes
    (70001, 384, 512, 32, "l2", "equal"),
    (70001, 384, 130, 64, "ip", "equal"),
    (70001, 384, 256, 32, "ip", "rising"),   # cuts in consecutive rounds
    (70001, 384, 256, 33, "l2", "rising"),
    (30000, 3072, 130, 32, "ip", "rising"),
    (70001, 384, 512, 32, "ip", "words"),    # whole 32-row words masked
    (70001, 384, 65, 64, "l2", "words"),
    (70001, 384, 65, 32, "ip", 0.95),        # the second tile holds one query
    (70001, 384, 129, 32, "l2", 0.95),       # one pair's second tile past Q: its consumer idles
    (70001, 384, 129, 1, "ip", 0.95),
    (70001, 384, 512, 1, "l2", 0.95),
    (70001, 384, 512, 33, "ip", 0.95),
    (70001, 384, 512, 64, "l2", 0.95),
    (70001, 384, 8, 64, "ip", 0.95),
])
def test_scan_topk_matches_plain_version(cuda, rs, d, nq, w, metric, live):
    salt = 0 if isinstance(live, float) else len(live)  # the named cases' own seeds
    gen = torch.Generator(device=cuda).manual_seed(rs + d + nq + w + salt)
    vecs, sc, valid, norms, qq, qs = _topk_operands(rs, d, nq, live, gen, cuda)
    nrm = norms if metric == "l2" else None
    before = scan_top2.scan_topk.launches
    s, p = scan_top2.scan_topk(vecs, sc, valid, nrm, qq, qs, w)
    torch.cuda.synchronize()
    assert scan_top2.scan_topk.launches == before + 1
    rs_, rp = scan_top2.scan_topk_reference(vecs, sc, valid, nrm, qq, qs, w)
    assert torch.equal(s.view(torch.int32), rs_.view(torch.int32))
    assert torch.equal(p, rp)


def test_scan_topk_geometry_is_what_the_library_accepts(cuda):
    """topk_geometry's launch runs; one stage more than fit, other
    shared-memory bytes, a grid that is no multiple of the query pairs or
    other merge bytes are refused by the entry point (cudaErrorInvalidValue).
    At d 512 (four ring chunks) the geometry takes as many stages as fit."""
    rs, d, nq, w = 5000, 512, 200, 32
    gen = torch.Generator(device=cuda).manual_seed(8)
    vecs, sc, valid, _, qq, qs = _topk_operands(rs, d, nq, 0.95, gen, cuda)
    geom = scan_top2.topk_geometry(rs, d, nq, torch.cuda.get_device_properties(cuda)
                                   .multi_processor_count, w)
    part = torch.empty(2 * nq * geom.lists * w + nq + scan_top2.COUNTERS + nq * geom.lists,
                       dtype=torch.int32, device=cuda)
    out_s = torch.empty((nq, w), device=cuda)
    out_i = torch.empty((nq, w), dtype=torch.int64, device=cuda)
    lib = scan_top2._library.get()
    n_part = nq * geom.lists * w

    def call(grid=geom.grid, stages=geom.stages, smem=geom.smem_bytes,
             merge=geom.merge_smem_bytes):
        return lib.semcode_scan_topk(
            vecs.data_ptr(), sc.data_ptr(), valid.data_ptr(), None, qq.data_ptr(),
            qs.data_ptr(), part.data_ptr(), part.data_ptr() + 4 * n_part,
            part.data_ptr() + 8 * n_part, out_s.data_ptr(), out_i.data_ptr(),
            rs, d, nq, w, 0, grid, stages, smem, geom.merge_warps, merge,
            torch.cuda.current_stream().cuda_stream)

    assert call() == 0
    torch.cuda.synchronize()
    rs_, rp = scan_top2.scan_topk_reference(vecs, sc, valid, None, qq, qs, w)
    assert torch.equal(out_s, rs_) and torch.equal(out_i, rp)
    assert call(stages=geom.stages + 1, smem=geom.smem_bytes + scan_top2.STAGE_BYTES) != 0
    assert call(smem=geom.smem_bytes + 1024) != 0
    assert call(grid=geom.grid - 1) != 0
    assert call(merge=geom.merge_smem_bytes + 8) != 0


def test_scan_topk_counters(cuda):
    """The kernel's counters on constructed cases: a tie storm (every row
    the same) appends in every offer round and cuts every buffer at least
    once an item; rows that never beat an established limit (each CTA's
    rows falling, so after its first item nothing passes) add no append
    round and no cut: at most one item's rounds a warp and one cut a query a
    list."""
    d, nq, w = 384, 256, 32
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    gen = torch.Generator(device=cuda).manual_seed(9)
    for case in ("ties", "falling"):
        lists = scan_top2.topk_geometry(10**6, d, nq, sms, w).lists
        rs = 256 * lists * 6  # six items a CTA
        geom = scan_top2.topk_geometry(rs, d, nq, sms, w)
        assert geom.lists == lists
        vecs, sc, valid, _, qq, qs = _topk_operands(rs, d, nq, "equal", gen, cuda)
        valid[:] = True
        if case == "falling":
            # tile j of list l holds rows that score below every row of its
            # earlier tiles
            tile = torch.arange(rs, device=cuda) // 256
            sc = sc[0] * (2.0 - (tile // lists).float() / 8 - (torch.arange(rs, device=cuda) % 256) / 4096)
            qq[:] = vecs[0]
        s, p = scan_top2.scan_topk(vecs, sc, valid, None, qq, qs, w)
        rounds, cuts = scan_top2.scan_topk_counts()
        rs_, rp = scan_top2.scan_topk_reference(vecs, sc, valid, None, qq, qs, w)
        assert torch.equal(s.view(torch.int32), rs_.view(torch.int32)) and torch.equal(p, rp)
        items = rs // 256 // lists
        warp_items = geom.grid * 8 * items
        # an append round: one lane's 8 rows of one query (32 lanes x 2
        # queries x 8 rounds in a warp's item)
        if case == "ties":
            assert rounds == 512 * warp_items
            assert cuts >= nq * lists * items
        else:
            assert 0 < rounds <= 512 * geom.grid * 8
            assert 0 < cuts <= nq * lists


def _ivf_operands(storage, nlist, cmax, d, nq, nprobe, gen, device):
    """Cluster blocks with ~10% empty slots and duplicated rows (ties)."""
    x = torch.randn(nlist, cmax, d, generator=gen, device=device)
    x = x / x.norm(dim=2, keepdim=True)
    x[:, 8:16] = x[:, 0:8]
    ids = torch.arange(nlist * cmax, device=device, dtype=torch.int32)
    ids = ids.reshape(nlist, cmax)
    empty = torch.rand(nlist, cmax, generator=gen, device=device) < 0.1
    ids = torch.where(empty, -1, ids)
    q = torch.randn(nq, d, generator=gen, device=device)
    q = q / q.norm(dim=1, keepdim=True)
    probes = torch.argsort(torch.rand(nq, nlist, generator=gen, device=device),
                           dim=1)[:, :nprobe].to(torch.int32)
    scales = None
    if storage == "int8":
        scales = torch.clamp(x.abs().amax(2), min=1e-12) / 127.0
        x = torch.clamp(torch.round(x / scales[..., None]), -127, 127).to(torch.int8)
    else:
        x = x.to(torch.bfloat16 if storage == "bfloat16" else torch.float32)
    return x, ids, q, probes, scales


def untied_ids_equal(s_ref, i_ref, i_got, tol):
    """Ids equal at every position whose reference score stands apart from
    its neighbours by more than ``tol`` (the last column, the boundary with
    the unreturned candidates, is excluded)."""
    gap = s_ref[:, :-1] - s_ref[:, 1:]
    apart = torch.ones_like(s_ref, dtype=torch.bool)
    apart[:, 1:] &= gap > tol
    apart[:, :-1] &= gap > tol
    apart[:, -1] = False
    return bool(torch.equal(i_got[apart], i_ref[apart]))


@pytest.mark.parametrize("storage", ["int8", "bfloat16", "float32"])
@pytest.mark.parametrize("nlist,cmax,d,nq,nprobe,k", [
    (16, 128, 128, 1, 1, 10),
    (64, 256, 384, 8, 16, 64),
    (256, 128, 128, 8, 128, 10),
    (32, 128, 3072, 8, 4, 64),
    (1024, 2176, 384, 512, 32, 64),
])
def test_ivf_scan_matches_plain_version(cuda, storage, nlist, cmax, d, nq,
                                        nprobe, k):
    from semcode_tpu_torch.ops import ivf_scan as ivf_ops

    gen = torch.Generator(device=cuda).manual_seed(nlist + cmax + d + nq)
    data, ids, q, probes, scales = _ivf_operands(storage, nlist, cmax, d, nq,
                                                 nprobe, gen, cuda)
    before = ivf_ops.ivf_scan.launches
    s, i = ivf_ops.ivf_scan(data, ids, q, probes, k, scales)
    torch.cuda.synchronize()
    assert ivf_ops.ivf_scan.launches == before + 1
    rs, ri = ivf_ops.ivf_scan_reference(data, ids, q, probes, k, scales)
    if storage == "int8":
        assert torch.equal(s, rs) and torch.equal(i, ri)
    else:
        torch.testing.assert_close(s, rs, rtol=1e-5, atol=1e-6)
        assert untied_ids_equal(rs, ri, i, 1e-5)


def _crowded_probes(nq, nlist, nprobe, gen, device):
    """Probes over clusters 3.. with cluster 0 probed by queries 0-63, 1 by
    queries 0-64 and 2 by every query: a full 64-query tile, a tile and one
    more, and the most tiles one cluster can take."""
    probes = torch.argsort(torch.rand(nq, nlist - 3, generator=gen, device=device),
                           dim=1)[:, :nprobe] + 3
    probes[:64, 0] = 0
    probes[:65, 1] = 1
    probes[:, 2] = 2
    return probes


def _empty_tails(ids, gen):
    """Empty tails, as a layout leaves them after each cluster's rows:
    cluster 0 keeps 129 slots, 1 keeps 128, 2 all, 3 none, 4 one, the rest
    a random count (the holes already in ids stay)."""
    nlist, cmax = ids.shape
    keep = torch.randint(0, cmax + 1, (nlist,), generator=gen, device=ids.device)
    keep[:5] = torch.tensor([129, 128, cmax, 0, 1], device=ids.device)
    slot = torch.arange(cmax, device=ids.device)
    return torch.where(slot[None, :] < keep[:, None], ids, -1)


@pytest.mark.parametrize("nlist,cmax,d,nq,nprobe,k", [
    (64, 2176, 384, 200, 16, 64),
    (256, 2176, 128, 100, 128, 10),
    (16, 2176, 384, 700, 8, 64),
])
def test_ivf_scan_int8_crowded_clusters(cuda, nlist, cmax, d, nq, nprobe, k):
    """int8 at cmax 2176 with clusters probed by 64, by 65 and by all Q
    queries (tiles that end at, past and far past a 64-query box), empty
    tails of every length (the scan stops at a cluster's last valid
    chunk), nprobe up to 128 and k 10: bit-identical scores and identical
    ids, ties included (the order (score, cluster, slot) is total)."""
    from semcode_tpu_torch.ops import ivf_scan as ivf_ops

    gen = torch.Generator(device=cuda).manual_seed(nlist + nq + nprobe)
    data, ids, q, _, scales = _ivf_operands("int8", nlist, cmax, d, nq, nprobe,
                                            gen, cuda)
    ids = _empty_tails(ids, gen)
    probes = _crowded_probes(nq, nlist, nprobe, gen, cuda)
    s, i = ivf_ops.ivf_scan(data, ids, q, probes, k, scales)
    torch.cuda.synchronize()
    rs, ri = ivf_ops.ivf_scan_reference(data, ids, q, probes, k, scales)
    assert torch.equal(s, rs) and torch.equal(i, ri)


@pytest.mark.parametrize("storage", ["bfloat16", "float32"])
@pytest.mark.parametrize("nlist,cmax,d,nq,nprobe,k", [
    (64, 2176, 384, 200, 16, 64),
    (256, 2176, 128, 100, 128, 10),
    (16, 2176, 3072, 70, 8, 64),
])
def test_ivf_scan_float_crowded_clusters(cuda, storage, nlist, cmax, d, nq,
                                         nprobe, k):
    """bf16/f32 at cmax 2176 with clusters probed by 64, by 65 and by all Q
    queries (bf16 tiles of 20, f32 tiles of 32: tiles that end at, past and
    far past the probers of one cluster), empty tails of every length,
    nprobe up to 128: scores by the float rule and ids equal at untied
    positions."""
    from semcode_tpu_torch.ops import ivf_scan as ivf_ops

    gen = torch.Generator(device=cuda).manual_seed(nlist + nq + nprobe + d)
    data, ids, q, _, scales = _ivf_operands(storage, nlist, cmax, d, nq, nprobe,
                                            gen, cuda)
    ids = _empty_tails(ids, gen)
    probes = _crowded_probes(nq, nlist, nprobe, gen, cuda)
    s, i = ivf_ops.ivf_scan(data, ids, q, probes, k, scales)
    torch.cuda.synchronize()
    rs, ri = ivf_ops.ivf_scan_reference(data, ids, q, probes, k, scales)
    torch.testing.assert_close(s, rs, rtol=1e-5, atol=1e-6)
    assert untied_ids_equal(rs, ri, i, 1e-5)


@pytest.mark.parametrize("storage", ["int8", "bfloat16", "float32"])
def test_ivf_scan_one_query_every_probe(cuda, storage):
    """Q = 1 at d 3072, cmax 128, k 64 and nprobe 128 (every tile holds one
    query), empty tails of every length: against the plain version."""
    from semcode_tpu_torch.ops import ivf_scan as ivf_ops

    gen = torch.Generator(device=cuda).manual_seed(3072)
    data, ids, q, probes, scales = _ivf_operands(storage, 160, 128, 3072, 1, 128,
                                                 gen, cuda)
    ids = _empty_tails(ids, gen)
    s, i = ivf_ops.ivf_scan(data, ids, q, probes, 64, scales)
    torch.cuda.synchronize()
    rs, ri = ivf_ops.ivf_scan_reference(data, ids, q, probes, 64, scales)
    if storage == "int8":
        assert torch.equal(s, rs) and torch.equal(i, ri)
    else:
        torch.testing.assert_close(s, rs, rtol=1e-5, atol=1e-6)
        assert untied_ids_equal(rs, ri, i, 1e-5)


@pytest.mark.parametrize("storage", ["int8", "bfloat16", "float32"])
def test_ivf_scan_geometry_is_what_the_entry_point_accepts(cuda, storage):
    """The scan launches at ivf_geometry's stages and shared memory, and
    its entry point refuses a stage more or other shared memory; the
    kernel spills nothing; the phase build computes the same scores and
    counts its cycles."""
    from semcode_tpu_torch.ops import ivf_scan as ivf_ops

    dtype = {"int8": torch.int8, "bfloat16": torch.bfloat16,
             "float32": torch.float32}[storage]
    gen = torch.Generator(device=cuda).manual_seed(7)
    data, ids, q, probes, scales = _ivf_operands(storage, 16, 128, 128, 8, 4,
                                                 gen, cuda)
    s, i = ivf_ops.ivf_scan(data, ids, q, probes, 10, scales)
    torch.cuda.synchronize()
    rs, _ = ivf_ops.ivf_scan_reference(data, ids, q, probes, 10, scales)
    torch.testing.assert_close(s, rs, rtol=1e-5, atol=1e-6)
    geom = ivf_ops.ivf_geometry(dtype, 16, 128, 128, 8, 4, 10, 132)
    lib = ivf_ops._library.get()
    stage = ivf_ops.stage_bytes(dtype)
    for stages, smem in ((geom.stages + 1, geom.smem_bytes + stage),
                         (geom.stages, geom.smem_bytes + 1024),
                         (1, geom.smem_bytes - (geom.stages - 1) * stage)):
        err = lib.semcode_ivf_scan(
            data.data_ptr(), ids.data_ptr(), q.data_ptr(), q.data_ptr(),
            q.data_ptr(), None, None,
            None, None, None, None, None, 16, 128, 128, 32, 4, 10,
            ivf_ops._STORAGE_CODES[dtype], 1, stages, smem, None)
        assert err != 0
    regs, spill = ivf_ops.scan_attributes(dtype)
    assert 0 < regs <= 255 and spill == 0
    # the phase build runs the whole scan, with its counters
    ivf_ops.scan_phases(dtype)
    ps, _ = ivf_ops.ivf_scan_probe("phases", data, ids, q, probes, 10, scales)
    torch.cuda.synchronize()
    torch.testing.assert_close(ps, rs, rtol=1e-5, atol=1e-6)
    phases = ivf_ops.scan_phases(dtype)
    assert phases["consumer total"] > 0 and phases["producer total"] > 0
    assert sum(phases[name] for name in ivf_ops.PHASE_NAMES[:6]) <= phases["consumer total"]


@pytest.mark.parametrize("nq,nlist,nprobe,tile", [
    (1, 16, 1, 64), (200, 64, 16, 64), (700, 16, 8, 64), (100, 256, 128, 32),
    (50, 70000, 32, 64),
])
def test_ivf_prep_matches_plain_version(cuda, nq, nlist, nprobe, tile):
    """The prep kernel's probe table, tiles, buckets and chunk counts
    against its plain version; repeats and out-of-range probes are skipped;
    the order inside a bucket is free."""
    from semcode_tpu_torch.ops import ivf_scan as ivf_ops

    gen = torch.Generator(device=cuda).manual_seed(nq + nlist + nprobe)
    probes = torch.randint(-2, nlist + 2, (nq, nprobe), generator=gen, device=cuda)
    cmax = 640 if nlist < 1000 else 128
    ids = torch.arange(nlist * cmax, device=cuda, dtype=torch.int32).view(nlist, cmax)
    ids = _empty_tails(torch.where(torch.rand(nlist, cmax, generator=gen, device=cuda)
                                   < 0.1, -1, ids), gen)
    table, pair_at, tiles, nchunk = ivf_ops.ivf_prep(probes, nlist, tile, ids)
    torch.cuda.synchronize()
    rt, rp, rtl, rn = ivf_ops.prep_reference(probes.cpu(), nlist, tile, ids.cpu())
    assert torch.equal(table.cpu(), rt) and torch.equal(tiles.cpu(), rtl)
    assert torch.equal(nchunk.cpu(), rn)
    buckets = {}  # cluster -> (first position, end)
    for c, p0, n in rtl.tolist():
        lo, _ = buckets.get(c, (p0, p0))
        buckets[c] = (lo, p0 + n)
    got = pair_at.cpu().clone()
    for lo, hi in buckets.values():
        got[lo:hi] = torch.sort(got[lo:hi]).values
    assert torch.equal(got, rp)


@pytest.mark.parametrize("nq,nprobe,k", [(1, 1, 10), (64, 32, 64), (33, 128, 10), (9, 128, 64)])
def test_ivf_merge_matches_plain_version(cuda, nq, nprobe, k):
    """The merge kernel against its plain version on sorted lists with tied
    scores across lists, empty (-3e38 / -1) tails and skipped probes."""
    from semcode_tpu_torch.ops import ivf_scan as ivf_ops

    gen = torch.Generator(device=cuda).manual_seed(nq * nprobe + k)
    n = nq * nprobe
    s = torch.randint(0, 5, (n, k), generator=gen, device=cuda).float() / 4
    s = torch.sort(s, dim=1, descending=True).values
    tail = torch.randint(0, k + 1, (n, 1), generator=gen, device=cuda)
    empty = torch.arange(k, device=cuda)[None, :] >= tail
    s = torch.where(empty, ivf_ops.NEG, s)
    i = torch.randint(0, 1 << 30, (n, k), generator=gen, device=cuda, dtype=torch.int32)
    i = torch.where(empty, -1, i)
    table = torch.argsort(torch.rand(nq, 4 * nprobe, generator=gen, device=cuda),
                          dim=1)[:, :nprobe].to(torch.int32)
    table = torch.where(torch.rand(nq, nprobe, generator=gen, device=cuda) < 0.2,
                        -1, table)
    got_s, got_i = ivf_ops.ivf_merge(s, i, table, k)
    torch.cuda.synchronize()
    want_s, want_i = ivf_ops.merge_reference(s, i, table, k)
    assert torch.equal(got_s, want_s) and torch.equal(got_i, want_i)


@pytest.mark.parametrize("mode", ["s32", "bf16"])
@pytest.mark.parametrize("rtile", [64, 128, 256])
@pytest.mark.parametrize("n,d,nq", [(1, 128, 1), (100, 384, 8), (70001, 1024, 512)])
def test_dot_max_matches_plain_version(cuda, mode, rtile, n, d, nq):
    from semcode_tpu_torch.ops import dot_max as dot_ops

    gen = torch.Generator(device=cuda).manual_seed(n + d + nq + rtile)
    low = -128 if mode == "s32" else -127
    rows = torch.randint(low, 128, (n, d), generator=gen, device=cuda,
                         dtype=torch.int32).to(torch.int8)
    q = torch.randint(low, 128, (nq, d), generator=gen, device=cuda,
                      dtype=torch.int32).to(torch.int8)
    rows[n // 2] = 127
    rows[n - 1] = low
    q[nq - 1] = low
    before = dot_ops.dot_max.launches
    got = dot_ops.dot_max(rows, q, mode=mode, rtile=rtile)
    torch.cuda.synchronize()
    assert dot_ops.dot_max.launches == before + 1
    assert torch.equal(got, dot_ops.dot_max_reference(rows, q))


def _dot_check(dot_ops, rows, q):
    want = dot_ops.dot_max_reference(rows, q)
    for mode in ("s32", "bf16"):
        for rtile in dot_ops.RTILES:
            before = dot_ops.dot_max.mode_launches[mode]
            got = dot_ops.dot_max(rows, q, mode=mode, rtile=rtile)
            torch.cuda.synchronize()
            assert dot_ops.dot_max.mode_launches[mode] == before + 1
            assert torch.equal(got, want), (mode, rtile)


@pytest.mark.parametrize("n", [63, 65, 127, 129, 255, 257, 513])
@pytest.mark.parametrize("nq", [63, 64, 65, 257])
def test_dot_max_tile_edges(cuda, n, nq):
    """N at row-tile multiples +- 1 and Q at the 64-query tile's edges, both
    modes, every row tile: bit for bit."""
    from semcode_tpu_torch.ops import dot_max as dot_ops

    gen = torch.Generator(device=cuda).manual_seed(n * 3 + nq)
    rows = torch.randint(-127, 128, (n, 384), generator=gen, device=cuda,
                         dtype=torch.int32).to(torch.int8)
    q = torch.randint(-127, 128, (nq, 384), generator=gen, device=cuda,
                      dtype=torch.int32).to(torch.int8)
    rows[n - 1] = -127  # in the ragged last tile
    q[nq - 1] = -127    # every maximum of this query is negative
    _dot_check(dot_ops, rows, q)


def test_dot_max_bf16_at_its_largest_sums(cuda):
    """Every operand +-127 at d = 1024: sums up to 1024 * 127**2 = 16.5M,
    just below 2**24, exact in both modes."""
    from semcode_tpu_torch.ops import dot_max as dot_ops

    gen = torch.Generator(device=cuda).manual_seed(1024)
    sign = lambda shape: torch.where(  # noqa: E731
        torch.rand(shape, generator=gen, device=cuda) < 0.5, -127, 127
    ).to(torch.int8)
    rows, q = sign((20000, 1024)), sign((300, 1024))
    rows[777] = 127
    q[0] = 127
    q[1] = -127
    _dot_check(dot_ops, rows, q)
    assert int(dot_ops.dot_max(rows, q, mode="bf16")[0]) == 1024 * 127 * 127


@pytest.mark.parametrize("mode", ["s32", "bf16"])
@pytest.mark.parametrize("rtile", [64, 128, 256])
def test_dot_max_geometry_is_what_the_library_accepts(cuda, mode, rtile):
    from semcode_tpu_torch.ops import dot_max as dot_ops

    n, d, nq = 3000, 384, 100
    rows = torch.zeros((n, d), dtype=torch.int8, device=cuda)
    # bf16 mode's entry point reads the queries widened
    q = torch.zeros((nq, d), dtype=torch.int8 if mode == "s32" else torch.bfloat16,
                    device=cuda)
    out = torch.full((nq,), dot_ops.INT32_MIN, dtype=torch.int32, device=cuda)
    geom = dot_ops.dot_geometry(n, d, nq, torch.cuda.get_device_properties(cuda)
                                .multi_processor_count, mode, rtile)
    lib = dot_ops._library.get()

    def call(stages, raw, smem):
        return lib.semcode_dot_max(
            rows.data_ptr(), q.data_ptr(), out.data_ptr(), n, d, nq,
            dot_ops.MODES[mode], rtile, geom.grid, stages, raw, smem,
            torch.cuda.current_stream().cuda_stream)

    assert call(geom.stages, geom.raw_stages, geom.smem_bytes) == 0
    torch.cuda.synchronize()
    assert int(out.max()) == 0 and int(out.min()) == 0
    step = dot_ops.stage_bytes(rtile)
    assert call(geom.stages + 1, geom.raw_stages, geom.smem_bytes + step) != 0
    assert call(geom.stages, 1 - geom.raw_stages // 2, geom.smem_bytes) != 0


def test_flat_index_card_matches_cpu(cuda):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((5000, 384)).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    q = x[:16] + 0.05 * rng.standard_normal((16, 384)).astype(np.float32)
    out = {}
    for dev in ("cpu", "cuda"):
        idx = FlatIndex(384, dtype="int8", scan_impl="pallas", device=dev)
        idx.add(x)
        idx.remove(np.arange(0, 5000, 11))
        out[dev] = idx.search(q, 10)
    np.testing.assert_array_equal(out["cuda"][1], out["cpu"][1])
    np.testing.assert_allclose(out["cuda"][0], out["cpu"][0], rtol=1e-5, atol=1e-6)


def test_ivf_index_card_matches_cpu(cuda):
    """One saved state loaded on both devices holds one cluster layout; the
    card's probing path (the kernel) and exact path return the CPU's ids
    (plain versions). An index built on the card from scratch reaches the
    same recall."""
    from semcode_tpu_torch.index.ivf import IVFIndex
    from semcode_tpu_torch.ops import ivf_scan as ivf_ops

    rng = np.random.default_rng(1)
    centers = rng.standard_normal((64, 384)).astype(np.float32)
    x = centers[rng.integers(0, 64, 20000)]
    x += 0.3 * rng.standard_normal(x.shape).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    q = x[:16] + 0.05 * rng.standard_normal((16, 384)).astype(np.float32)
    kw = dict(dtype="int8", use_pallas="always")
    built = IVFIndex(384, nlist=64, nprobe=8, device="cpu", **kw)
    built.add(x)
    built.remove(np.arange(0, 20000, 13))
    state = built.state_dict()
    cpu = IVFIndex.from_state(state, device="cpu", **kw)
    card = IVFIndex.from_state(state, device=cuda, **kw)
    assert card._pallas_mode() == "compiled" and card.cmax == cpu.cmax
    for mode in ("ivf", "exact"):
        before = ivf_ops.ivf_scan.launches
        sc, ic = card.search(q, 10, mode=mode)
        sp, ip = cpu.search(q, 10, mode=mode)
        assert (ivf_ops.ivf_scan.launches > before) == (mode == "ivf")
        np.testing.assert_array_equal(ic, ip)
        np.testing.assert_allclose(sc, sp, rtol=1e-5, atol=1e-6)
    truth = np.argsort(-(q @ x.T), axis=1)[:, :10]
    fresh = IVFIndex(384, nlist=64, nprobe=8, device=cuda, **kw)
    fresh.add(x)
    _, ids = fresh.search(q, 10, mode="ivf")
    hits = sum(len(set(a) & set(b)) for a, b in zip(ids.tolist(), truth.tolist()))
    assert hits / truth.size >= 0.95


def test_hash_projection_card_equals_cpu(cuda):
    a = HashEmbeddings(384, device="cpu").projection()
    b = HashEmbeddings(384, device=cuda).projection()
    assert np.array_equal(a, b)


@pytest.mark.parametrize("max_new", [1, 2, 33])
def test_decoder_graph_replays_the_eager_step(cuda, max_new):
    """The causal decoder's captured decode step gives the eager step's
    tokens bit for bit (bfloat16), replays once per token, and a float32
    decoder on the card gives the CPU path's greedy tokens; seeded sampling
    repeats."""
    from pathlib import Path

    from semcode_tpu_torch.models.decoder import CodeDecoderLM, generate_tokens

    fixture = Path(__file__).resolve().parents[1] / "semcode_tpu_torch" / "assets" / "lm-tiny"
    prompt = "### Context\ndef quantize_rows(x):\n\n### Question\nwhat does it do?\n\n### Answer\n"
    lm = CodeDecoderLM(weights_path=fixture, device=cuda)
    arr, msk, n = lm.prompt_arrays(prompt, max_new)
    graphed = generate_tokens(lm.model, arr, msk, max_new=n)
    eager = generate_tokens(lm.model, arr, msk, max_new=n, graph=False)
    assert torch.equal(graphed, eager)
    assert lm.model.counts["graph_replays"] == n - 1
    assert lm.model.counts["graph_captures"] == (n > 1)
    card = CodeDecoderLM(weights_path=fixture, dtype="float32", device=cuda)
    cpu = CodeDecoderLM(weights_path=fixture, dtype="float32", device="cpu")
    assert card.generate_ids(prompt, max_new_tokens=max_new) == cpu.generate_ids(
        prompt, max_new_tokens=max_new)
    # sampling runs the step eagerly from a generator seeded on every call
    hot = dict(max_new_tokens=max_new, temperature=0.8)
    assert lm.generate_ids(prompt, seed=3, **hot) == lm.generate_ids(prompt, seed=3, **hot)


def _trainer_batches(kind, n, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        lens = rng.integers(3, 33, size=(2, 8))
        masks = (np.arange(32)[None, None] < lens[..., None]).astype(np.int32)
        ids = np.where(masks > 0, rng.integers(2, 512, size=(2, 8, 32)), 0).astype(np.int32)
        if kind == "encoder":
            ids[:, :, 0] = 1
            out.append({"anchor_ids": ids[0], "anchor_mask": masks[0],
                        "pos_ids": ids[1], "pos_mask": masks[1]})
        else:
            out.append({"ids": ids[0], "mask": masks[0]})
    return out


@pytest.mark.parametrize("kind", ["encoder", "lm"])
def test_trainer_step_card_matches_cpu(cuda, kind):
    """One float32 train step of each trainer on the card against its CPU
    path (same init, same batch): the loss and accuracy within 1e-5, every
    gradient entry within 1e-4 of its tensor's largest entry (+ 1e-6: an
    entry summed from cancelling terms keeps the larger terms' rounding,
    which cuBLAS and the CPU make in their own orders), and the next step's
    loss within 1e-4 relative."""
    from semcode_tpu_torch.models import decoder, encoder, train, train_lm

    small = dict(vocab_size=512, hidden=64, layers=2, heads=4, mlp_dim=128, max_len=32)
    if kind == "encoder":
        cfg = encoder.EncoderConfig(dtype=torch.float32, **small)
        state = encoder.random_state(cfg, 0)
        trainer_cls = train.ContrastiveTrainer
    else:
        cfg = decoder.DecoderConfig(dtype=torch.float32, **small)
        state = decoder.decoder_state_from_jax(decoder.init_params(cfg, seed=0))
        trainer_cls = train_lm.LMTrainer
    b1, b2 = _trainer_batches(kind, 2)
    out = {}
    for dev in ("cpu", cuda):
        trainer = trainer_cls(cfg, learning_rate=1e-3, device=dev)
        params, opt = trainer.state_from(state)
        metrics, grads = trainer.value_and_grad(params, b1)
        grads = {k: g.detach().cpu().clone() for k, g in grads.items()}
        opt.step()
        nxt, _ = trainer.value_and_grad(params, b2)
        out[str(dev)] = (metrics, grads, float(nxt["loss"]))
    (mc, gc, lc), (mp, gp, lp) = out["cuda"], out["cpu"]
    assert abs(float(mc["loss"]) - float(mp["loss"])) <= 1e-5
    assert abs(float(mc["accuracy"]) - float(mp["accuracy"])) <= 1e-5
    for name, g in gp.items():
        tol = 1e-4 * g.abs().max().item() + 1e-6
        assert (gc[name] - g).abs().max().item() <= tol, name
    assert abs(lc - lp) <= 1e-4 * abs(lp)


def test_term_table_training_card_matches_cpu(cuda):
    """Five steps of the term reranker's training at a small geometry on the
    card and on the CPU, same features: logged losses within 1e-4 relative,
    the tables' rows at cosine >= 0.9999."""
    from semcode_tpu_torch.models import term_reranker as tr

    rng = np.random.default_rng(2)
    q_ids = np.where(rng.random((64, 16)) < 0.5, rng.integers(0, 4096, (64, 16)), -1)
    d_ids = np.where(rng.random((64, 24)) < 0.7, rng.integers(0, 4096, (64, 24)), -1)
    q_ids[:, 0] = rng.integers(0, 4096, 64)
    feats = {"q_ids": q_ids.astype(np.int32), "d_ids": d_ids.astype(np.int32)}
    tables, losses = {}, {}
    for dev in ("cpu", cuda):
        lines = []
        tables[str(dev)] = tr.train_term_table(feats, n_buckets=4096, dim=16, steps=5,
                                               batch_size=16, log_every=1, log=lines.append,
                                               device=dev)
        losses[str(dev)] = [float(s.split("loss=")[1].split()[0]) for s in lines]
    np.testing.assert_allclose(losses["cuda"], losses["cpu"], rtol=1e-4)
    a, b = tables["cuda"], tables["cpu"]
    cos = (a * b).sum(1) / np.linalg.norm(a, axis=1) / np.linalg.norm(b, axis=1)
    assert cos.min() >= 0.9999


def test_dryrun_multichip_on_the_card(cuda):
    """``entry.dryrun_multichip(4)`` on the visible cards (one card repeated
    4 times on a one-card host): every sharded step, its checks and the
    reference's summary line."""
    from semcode_tpu_torch.entry import dryrun_multichip

    line = dryrun_multichip(4)
    assert line.startswith("dryrun_multichip ok: 4 devices (train mesh 2x2 dp x tp")
