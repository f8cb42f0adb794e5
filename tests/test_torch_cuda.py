"""Kernels and device paths of semcode_tpu_torch on a CUDA card.

Every test needs an NVIDIA card and nvcc and skips without them. This file
imports nothing of JAX, so it runs on a card host that has no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

(``--noconftest``: the suite's conftest configures JAX's CPU mesh.)
Comparisons hold each kernel against its plain torch version on the same
card inputs: int8 bit-identical (dot_max, an integer maximum, in both
modes); bf16/f32 within rtol 1e-5 (f32 sums run in another order).
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
