"""The IVF probing kernel's plain version against the Pallas kernel.

The same numpy cluster blocks, ids, queries and probe tables go through the
JAX ``ivf_scan_shard`` (Pallas interpret mode, one shard that owns every
probe) and the port's ``ivf_scan`` on the CPU, which runs its plain torch
version. Inputs hold empty (-1) slots and duplicated rows, so scores tie.
Required: int8 scores bit-identical (both compute the exact integer dot and
the same two f32 multiplies); bf16/f32 scores within rtol 1e-5 (f32 sums in
another order); ids identical at every position whose score stands apart
from its neighbours (the Pallas kernel's order among tied scores depends on
its running-slot reuse once more than 128 candidates reach a query's top-k).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from semcode_tpu.ops.kernels import ivf_scan_shard
from semcode_tpu_torch.ops import ivf_scan as ivf_ops
from semcode_tpu_torch.index.scan import stable_topk
from semcode_tpu_torch.ops.ivf_scan import NEG, ivf_scan, ivf_scan_reference, probe_table


def _inputs(storage, nlist, cmax, d, nq, nprobe, seed, tail=24):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((nlist, cmax, d)).astype(np.float32)
    x /= np.linalg.norm(x, axis=-1, keepdims=True)
    x[:, 8:16] = x[:, 0:8]  # duplicated rows: tied scores
    ids = np.arange(nlist * cmax, dtype=np.int32).reshape(nlist, cmax)
    ids[rng.random((nlist, cmax)) < 0.1] = -1  # tombstones
    ids[:, cmax - tail:] = -1  # the empty tail of each capacity-padded block
    q = rng.standard_normal((nq, d)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    probes = np.stack(
        [rng.choice(nlist, nprobe, replace=False) for _ in range(nq)]
    ).astype(np.int32)
    if storage == "int8":
        sc = (np.maximum(np.abs(x).max(-1), 1e-12) / 127.0).astype(np.float32)
        data = np.clip(np.rint(x / sc[..., None]), -127, 127).astype(np.int8)
        return data, ids, q, probes, sc, jnp.asarray(data), torch.from_numpy(data)
    jdt = jnp.bfloat16 if storage == "bfloat16" else jnp.float32
    jd = jnp.asarray(x).astype(jdt)
    tdt = torch.bfloat16 if storage == "bfloat16" else torch.float32
    td = torch.from_numpy(np.array(jd.astype(jnp.float32))).to(tdt)
    return x, ids, q, probes, None, jd, td


def untied_ids_equal(s_ref, i_ref, i_got, tol=0.0):
    """Ids equal wherever the reference score stands apart from both
    neighbours by more than ``tol``; the last column is excluded."""
    gap = s_ref[:, :-1] - s_ref[:, 1:]
    apart = np.ones(s_ref.shape, dtype=bool)
    apart[:, 1:] &= gap > tol
    apart[:, :-1] &= gap > tol
    apart[:, -1] = False
    return np.array_equal(i_got[apart], i_ref[apart])


def _run_both(storage, nlist, cmax, d, nq, nprobe, k, seed, tiles=None,
              tail=24):
    _, ids, q, probes, sc, jd, td = _inputs(storage, nlist, cmax, d, nq,
                                            nprobe, seed, tail)
    js, ji = ivf_scan_shard(
        jd, jnp.asarray(ids), jnp.asarray(q), jnp.asarray(probes),
        jnp.ones(probes.shape, jnp.int32), k=k, interpret=True,
        scales_s=None if sc is None else jnp.asarray(sc), tiles=tiles,
    )
    ts, ti = ivf_scan(td, torch.from_numpy(ids), torch.from_numpy(q),
                      torch.from_numpy(probes), k,
                      None if sc is None else torch.from_numpy(sc))
    return np.asarray(js), np.asarray(ji), ts.numpy(), ti.numpy()


def _check(storage, js, ji, ts, ti):
    if storage == "int8":
        np.testing.assert_array_equal(ts, js)
        assert untied_ids_equal(js, ji, ti)
    else:
        np.testing.assert_allclose(ts, js, rtol=1e-5, atol=1e-6)
        assert untied_ids_equal(js, ji, ti, tol=1e-5)
    # the tail of a query with fewer than k candidates is -3e38 / -1
    assert ((ti == -1) == (ts <= NEG / 2)).all()


@pytest.mark.parametrize("storage", ["int8", "bfloat16", "float32"])
@pytest.mark.parametrize("cmax,d,nq,nprobe,k", [
    (128, 128, 8, 1, 16),
    (128, 256, 16, 3, 64),
    (256, 128, 16, 8, 64),
    (256, 256, 8, 3, 16),
])
def test_plain_version_matches_pallas_kernel(storage, cmax, d, nq, nprobe, k):
    js, ji, ts, ti = _run_both(storage, 8, cmax, d, nq, nprobe, k,
                               seed=cmax + d + nq + nprobe)
    _check(storage, js, ji, ts, ti)


@pytest.mark.parametrize("storage", ["int8", "float32"])
def test_matches_dim_slab_and_row_split_variants(storage):
    """The Pallas kernel's dim-slab (dtile < d) and cluster row-split
    (ctile < cmax) tilings compute the same function."""
    js, ji, ts, ti = _run_both(storage, 8, 256, 256, 8, 3, 16, seed=5,
                               tiles=(128, 128))
    _check(storage, js, ji, ts, ti)


def test_fewer_candidates_than_k():
    """One probe of a cluster with at most 28 valid slots, k=64: the
    result's tail is empty."""
    js, ji, ts, ti = _run_both("int8", 8, 128, 128, 8, 1, 64, seed=9, tail=100)
    assert (ti[:, -1] == -1).all()
    _check("int8", js, ji, ts, ti)


def test_probe_table_orders_and_dedupes():
    p = torch.tensor([[5, 1, 5, 9], [3, -1, 2, 2]])
    assert probe_table(p, 8).tolist() == [[1, 5, -1, -1], [-1, 2, -1, 3]]


def test_cpu_wrapper_runs_the_plain_version():
    _, ids, q, probes, sc, _, td = _inputs("int8", 8, 128, 128, 4, 2, 3)
    args = (td, torch.from_numpy(ids), torch.from_numpy(q),
            torch.from_numpy(probes), 10, torch.from_numpy(sc))
    before = ivf_ops.ivf_scan.launches
    s, i = ivf_scan(*args)
    rs, ri = ivf_scan_reference(*args)
    assert torch.equal(s, rs) and torch.equal(i, ri)
    assert ivf_ops.ivf_scan.launches == before  # no kernel on the CPU
    assert s.dtype == torch.float32 and i.dtype == torch.int32
    assert (s[:, :-1] >= s[:, 1:]).all()


def test_argument_checks():
    _, ids, q, probes, sc, _, td = _inputs("int8", 8, 128, 128, 4, 2, 3)
    t_ids, t_q, t_p = torch.from_numpy(ids), torch.from_numpy(q), torch.from_numpy(probes)
    with pytest.raises(ValueError, match="per-row scales"):
        ivf_scan(td, t_ids, t_q, t_p, 10)
    with pytest.raises(ValueError, match="k <= 64"):
        ivf_scan(td, t_ids, t_q, t_p, 65, torch.from_numpy(sc))
    with pytest.raises(ValueError, match="multiples of 128"):
        ivf_scan(td[:, :100], t_ids[:, :100], t_q, t_p, 10,
                 torch.from_numpy(sc)[:, :100])


# -- the bf16 scan's query split -------------------------------------------------


def test_split_bf16x3_reconstructs_the_query():
    """hi + mid + lo == q exactly, over magnitudes from 1e-6 to 1e5; hi is
    q rounded to bf16 and each later part the rounding of what is left."""
    rng = np.random.default_rng(11)
    q = rng.standard_normal((32, 3072)).astype(np.float32)
    q *= (10.0 ** rng.integers(-6, 6, q.shape)).astype(np.float32)
    tq = torch.from_numpy(q)
    parts = ivf_ops.split_bf16x3(tq)
    assert parts.shape == (3, 32, 3072) and parts.dtype == torch.bfloat16
    assert torch.equal(parts.double().sum(0), tq.double())
    assert torch.equal(parts[0], tq.to(torch.bfloat16))
    rest = tq - parts[0].float()
    assert torch.equal(parts[1], rest.to(torch.bfloat16))
    assert torch.equal(parts[2].float(), rest - parts[1].float())


@pytest.mark.parametrize("d", [128, 384, 3072])
def test_three_part_bf16_products_hold_the_float_rule(d):
    """bf16 rows scored against the query's three bf16 parts as the scan
    sums them: each wgmma k16 step's 16 products exact (bf16 x bf16 fits
    f32) and handed on as f32, each part's steps summed in its own f32
    accumulator row, then hi + (mid + lo). Held to chip_smoke's float rule
    (rtol 1e-5, atol 1e-6) against ivf_scan_reference on the same rows,
    with a margin of 4x. The tensor cores' own accumulation is not modelled
    here; the chip run holds the kernel itself to the rule."""
    rng = np.random.default_rng(d)
    n, nq, k = 256, 16, 64
    x = rng.standard_normal((n, d)).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    q = rng.standard_normal((nq, d)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    rows = torch.from_numpy(x).to(torch.bfloat16)
    tq = torch.from_numpy(q)
    parts = ivf_ops.split_bf16x3(tq).double().view(3, nq, d // 16, 16)
    steps = torch.einsum("pqkd,nkd->pqnk", parts, rows.double().view(n, d // 16, 16)).float()
    acc = torch.zeros((3, nq, n), dtype=torch.float32)
    for j in range(d // 16):
        acc = acc + steps[:, :, :, j]
    got = acc[0] + (acc[1] + acc[2])
    ids = torch.arange(n, dtype=torch.int32).view(1, n)
    rs, ri = ivf_scan_reference(rows.view(1, n, d), ids, tq,
                                torch.zeros((nq, 1), dtype=torch.int64), k)
    at = torch.gather(got, 1, ri.long())
    torch.testing.assert_close(at, rs, rtol=1e-5, atol=1e-6)
    assert ((at - rs).abs() <= (1e-6 + 1e-5 * rs.abs()) / 4).all()


# -- launch geometry and the bookkeeping kernels' plain versions --------------


def _tiles_needed(counts, tile):
    return sum(-(-c // tile) for c in counts)


@pytest.mark.parametrize("cmax", [128, 2176])
@pytest.mark.parametrize("d", [128, 384, 3072])
@pytest.mark.parametrize("nq", [1, 8, 512])
@pytest.mark.parametrize("nprobe", [1, 32, 128])
def test_geometry_fits_and_bounds_the_tiles(cmax, d, nq, nprobe):
    """Shared memory within Hopper's 232,448 B per block for every storage,
    and a tile bound that covers every way the pairs can fall on the
    clusters: spread over all of them, in clusters of one tile and one pair
    more, or every query probing the same clusters."""
    for storage in (torch.int8, torch.bfloat16, torch.float32):
        int8 = storage == torch.int8
        for nlist in (16, 1024, 70000):
            if nprobe > nlist:
                continue
            g = ivf_ops.ivf_geometry(storage, nlist, cmax, d, nq, nprobe, 64, 132)
            n = nq * nprobe
            assert g.n_pairs == n
            assert g.smem_bytes <= ivf_ops.SMEM_LIMIT
            assert g.tile_bound == ivf_ops.tile_bound(n, nlist, g.query_tile)
            for k in (1, 10, 64):
                warps, smem = ivf_ops.merge_geometry(nprobe, k)
                assert 1 <= warps <= ivf_ops.MAX_MERGE_WARPS
                assert smem == warps * nprobe * k * 4 <= ivf_ops.MERGE_SMEM_MAX
            assert g.stages >= 3 and 1 <= g.grid <= min(132, g.tile_bound)
            fixed = (ivf_ops.SMEM_ALIGN + ivf_ops.EPILOGUE_BYTES + ivf_ops.MISC_BYTES
                     + ivf_ops.buffer_bytes(storage))
            assert g.smem_bytes == fixed + g.stages * ivf_ops.stage_bytes(storage)
            # one stage more would not fit
            assert g.smem_bytes + ivf_ops.stage_bytes(storage) > ivf_ops.SMEM_LIMIT
            assert g.query_tile == ivf_ops.query_tile(storage)
            assert ivf_ops.buffer_bytes(storage) == 8 * 192 * g.query_tile
            tile = g.query_tile
            per = min(nq, tile + 1)
            layouts = [
                [n // nlist + (c < n % nlist) for c in range(nlist)],
                [nq] * nprobe,
            ]
            if n // per < nlist:
                layouts.append([per] * (n // per) + [n % per])
            for counts in layouts:
                assert sum(counts) == n and max(counts) <= nq
                assert _tiles_needed(counts, tile) <= g.tile_bound


def test_geometry_rejects_what_the_kernel_cannot_run():
    for bad in [(100, 384, 8, 8, 10), (128, 100, 8, 8, 10), (128, 384, 8, 129, 10),
                (128, 384, 8, 8, 65), (128, 384, 0, 8, 10)]:
        cmax, d, nq, nprobe, k = bad
        with pytest.raises(ValueError):
            ivf_ops.ivf_geometry(torch.int8, 64, cmax, d, nq, nprobe, k, 132)
    with pytest.raises(ValueError):
        ivf_ops.ivf_geometry(torch.float16, 64, 128, 128, 8, 8, 10, 132)


def test_geometry_constants_match_the_source():
    """The constants ivf_geometry mirrors, read from csrc/ivf_scan.cu."""
    import re
    from pathlib import Path

    src = (Path(ivf_ops.__file__).parent / "csrc" / "ivf_scan.cu").read_text()
    const = {m.group(1): int(m.group(2))
             for m in re.finditer(r"constexpr int (k\w+) = (\d+);", src)}
    assert const["kQTile"] == ivf_ops.QUERY_TILE
    assert const["kFQueries"] == ivf_ops.FLOAT_QUERY_TILE
    assert const["kBQueries"] == ivf_ops.BF16_QUERY_TILE
    assert const["kRowChunk"] == ivf_ops.ROW_CHUNK
    assert const["kDepth"] == ivf_ops.DEPTH_CHUNK
    assert const["kQBox"] == ivf_ops.QUERY_BOX
    assert const["kFBox"] == ivf_ops.FLOAT_QUERY_BOX
    assert const["kParts"] == ivf_ops.QUERY_PARTS
    assert const["kCapMax"] == ivf_ops.CANDIDATES_MAX
    assert ivf_ops.CANDIDATE_POOL // ivf_ops.QUERY_TILE >= ivf_ops.MAX_K + ivf_ops.ROW_CHUNK
    assert (ivf_ops.FLOAT_CANDIDATE_POOL // ivf_ops.FLOAT_QUERY_TILE
            >= ivf_ops.MAX_K + ivf_ops.ROW_CHUNK)
    assert f"kPool = kQTile * {ivf_ops.CANDIDATE_POOL // ivf_ops.QUERY_TILE};" in src
    assert (f"kBPool = kBQueries * "
            f"{ivf_ops.BF16_CANDIDATE_POOL // ivf_ops.BF16_QUERY_TILE};") in src
    assert (f"kFPool = kFQueries * "
            f"{ivf_ops.FLOAT_CANDIDATE_POOL // ivf_ops.FLOAT_QUERY_TILE};") in src
    # the stage layouts: rows, then the query operands of each storage (a
    # 64-row M operand for int8 and bf16, whose warps' 16 rows hold the three
    # parts of up to 5 queries each; f32 the tile's 32 rows)
    assert "kRowBytes + (s == 2 ? kFQueries * kDepth : kQBytes)" in src
    assert "s == 0 ? kPool : s == 1 ? kBPool : kFPool" in src
    assert ivf_ops.QUERY_PARTS * -(-ivf_ops.BF16_QUERY_TILE // 4) <= ivf_ops.QUERY_BOX
    assert ivf_ops.FLOAT_QUERY_TILE % ivf_ops.FLOAT_QUERY_BOX == 0
    assert ivf_ops.STAGE_BYTES == (ivf_ops.ROW_CHUNK + ivf_ops.QUERY_TILE) * ivf_ops.DEPTH_CHUNK
    assert ivf_ops.BF16_STAGE_BYTES == ivf_ops.STAGE_BYTES
    assert ivf_ops.F32_STAGE_BYTES == (ivf_ops.ROW_CHUNK + ivf_ops.FLOAT_QUERY_TILE) * ivf_ops.DEPTH_CHUNK
    assert const["kMiscBytes"] == ivf_ops.MISC_BYTES
    assert const["kSmemAlign"] == ivf_ops.SMEM_ALIGN
    assert const["kSmemLimit"] == ivf_ops.SMEM_LIMIT
    assert const["kMergeSmemMax"] == ivf_ops.MERGE_SMEM_MAX
    assert const["kGatherRows"] == ivf_ops.GATHER_ROWS
    assert const["kMaxK"] == ivf_ops.MAX_K and const["kMaxProbe"] == ivf_ops.MAX_PROBE


def _random_probes(rng, nq, nprobe, nlist):
    """Probes with repeats inside a query and out-of-range entries."""
    p = rng.integers(0, nlist, (nq, nprobe))
    p[rng.random((nq, nprobe)) < 0.15] = -1
    p[rng.random((nq, nprobe)) < 0.05] = nlist + 3
    return torch.from_numpy(p.astype(np.int64))


@pytest.mark.parametrize("nq,nprobe,nlist,tile", [
    (1, 1, 4, 64), (16, 8, 12, 64), (130, 4, 3, 64), (40, 32, 64, 32), (9, 128, 300, 64),
])
def test_prep_plain_version_buckets_as_sort_and_bincount(nq, nprobe, nlist, tile):
    """prep_reference against the path it replaces (probe_table, a stable
    sort of the pairs by cluster, bincount, cumsum): the same probes per
    query, the same bucket of queries for every cluster, the same tiles."""
    rng = np.random.default_rng(nq * 31 + nprobe + nlist)
    probes = _random_probes(rng, nq, nprobe, nlist)
    table, pair_at, tiles = ivf_ops.prep_reference(probes, nlist, tile)
    # the old path
    old = probe_table(probes, nlist)
    cl = torch.where(old < 0, nlist, old).reshape(-1)
    cl_sorted, order = torch.sort(cl, stable=True)
    counts = torch.bincount(cl_sorted, minlength=nlist + 1)[:nlist]
    starts = torch.cat([torch.zeros(1, dtype=torch.int64), torch.cumsum(counts, 0)])
    for qi in range(nq):
        new_row = sorted(c for c in table[qi].tolist() if c >= 0)
        assert new_row == [c for c in old[qi].tolist() if c >= 0]
    flat = table.reshape(-1)
    got_counts = torch.zeros(nlist, dtype=torch.int64)
    for c, p0, n in tiles.tolist():
        got_counts[c] += n
        assert (flat[pair_at[p0:p0 + n].long()] == c).all()
    assert torch.equal(got_counts, counts)
    for c in range(nlist):
        lo, hi = int(starts[c]), int(starts[c + 1])
        want = sorted((order[lo:hi] // nprobe).tolist())
        got = sorted((pair_at[lo:hi] // nprobe).tolist())
        assert got == want
    want_tiles = [(c, int(starts[c]) + t0, min(tile, int(counts[c]) - t0))
                  for c in range(nlist) for t0 in range(0, int(counts[c]), tile)]
    assert [tuple(t) for t in tiles.tolist()] == want_tiles


@pytest.mark.parametrize("nq,nprobe,nlist,k", [
    (4, 1, 8, 10), (16, 8, 12, 64), (8, 128, 200, 10), (5, 32, 40, 64), (30, 3, 3, 16),
])
def test_merge_plain_version_matches_stable_topk(nq, nprobe, nlist, k):
    """merge_reference against the path it replaces: a stable top-k over
    each query's partial lists laid out in ascending cluster order (probe
    skipped -> a -3e38 / -1 list), then a gather of the ids. Scores tie
    within and across lists, lists end in empty tails; scores and ids must
    be equal, ties included."""
    rng = np.random.default_rng(nq * 7 + nprobe * 3 + k)
    probes = _random_probes(rng, nq, nprobe, nlist)
    table, _, _ = ivf_ops.prep_reference(probes, nlist, 64)
    old = probe_table(probes, nlist)
    lists = {}

    def pair_list(qi, c):
        if (qi, c) not in lists:
            s = np.sort(rng.integers(0, 5, k).astype(np.float32) / 4)[::-1].copy()
            ids = rng.integers(0, 1 << 30, k).astype(np.int32)
            tail = rng.integers(0, k + 1)
            s[tail:] = NEG
            ids[tail:] = -1
            lists[(qi, c)] = (s, ids)
        return lists[(qi, c)]

    new_s = rng.standard_normal((nq * nprobe, k)).astype(np.float32)  # unread
    new_i = rng.integers(0, 9, (nq * nprobe, k)).astype(np.int32)
    old_s = np.full((nq * nprobe, k), NEG, dtype=np.float32)
    old_i = np.full((nq * nprobe, k), -1, dtype=np.int32)
    for qi in range(nq):
        for j in range(nprobe):
            c = int(table[qi, j])
            if c >= 0:
                new_s[qi * nprobe + j], new_i[qi * nprobe + j] = pair_list(qi, c)
            c = int(old[qi, j])
            if c >= 0:
                old_s[qi * nprobe + j], old_i[qi * nprobe + j] = pair_list(qi, c)
    top, pos = stable_topk(torch.from_numpy(old_s).view(nq, nprobe * k), k)
    want_i = torch.gather(torch.from_numpy(old_i).view(nq, nprobe * k), 1, pos)
    got_s, got_i = ivf_ops.merge_reference(torch.from_numpy(new_s),
                                           torch.from_numpy(new_i), table, k)
    assert torch.equal(got_s, top) and torch.equal(got_i, want_i)
    # the CPU wrappers of the two kernels run the plain versions
    cs, ci = ivf_ops.ivf_merge(torch.from_numpy(new_s), torch.from_numpy(new_i), table, k)
    assert torch.equal(cs, got_s) and torch.equal(ci, got_i)
    assert all(torch.equal(a, b) for a, b in zip(ivf_ops.ivf_prep(probes, nlist),
                                                  ivf_ops.prep_reference(probes, nlist, 64)))


@pytest.mark.parametrize("nlist,cmax", [(6, 128), (9, 640)])
def test_prep_plain_version_counts_chunks_to_the_last_valid_slot(nlist, cmax):
    """With ids, prep_reference's nchunk: for each probed cluster the
    128-slot chunks up to its last valid slot (holes before it count), 0
    for an empty or unprobed cluster; the CPU wrapper returns the same."""
    rng = np.random.default_rng(nlist + cmax)
    ids = np.arange(nlist * cmax, dtype=np.int32).reshape(nlist, cmax)
    lengths = [0, 1, 128, 129, cmax, rng.integers(0, cmax)] + [cmax] * (nlist - 6)
    for c, n in enumerate(lengths):
        ids[c, n:] = -1
    ids[rng.random((nlist, cmax)) < 0.3] = -1  # holes
    probes = torch.from_numpy(rng.integers(-1, nlist - 1, (5, 3)).astype(np.int64))
    out = ivf_ops.prep_reference(probes, nlist, 64, torch.from_numpy(ids))
    probed = set(probes[(probes >= 0)].tolist())
    want = []
    for c in range(nlist):
        valid = np.nonzero(ids[c] >= 0)[0]
        last = int(valid[-1]) // 128 + 1 if c in probed and valid.size else 0
        want.append(last)
    assert out[3].tolist() == want and out[3].dtype == torch.int32
    assert all(torch.equal(a, b) for a, b in zip(out[:3], ivf_ops.prep_reference(probes, nlist, 64)))
    got = ivf_ops.ivf_prep(probes, nlist, 64, torch.from_numpy(ids))
    assert len(got) == 4 and all(torch.equal(a, b) for a, b in zip(got, out))
