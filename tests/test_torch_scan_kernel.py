"""top2_scan (semcode_tpu_torch/ops/scan_top2.py) against the Pallas kernel.

The plain torch version ``top2_scan_reference`` — what the wrapper runs on
CPU tensors — is held against ``semcode_tpu.ops.scan_kernel2.
top2_scan_shard`` in Pallas interpret mode on the same numpy inputs. int8:
identical rows and scores within 1e-6 (both dots are exact integers);
bf16/f32: scores within rtol 1e-5 (f32 accumulation order differs), rows
identical where a block's top-2 are separated by more than 1e-4. The CUDA
kernel itself is compared with the plain version on the card only
(tests/test_torch_cuda.py); its launch geometry (``scan_geometry``) is
checked here for every storage, with the constants the source repeats.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from semcode_tpu.ops.scan_kernel2 import top2_scan_shard
from semcode_tpu_torch.ops.scan_top2 import (
    BARRIER_BYTES,
    DEPTH_CHUNK,
    EPILOGUE_BYTES,
    NEG,
    QUERY_TILE,
    RAW_STAGE_BYTES,
    RAW_STAGES,
    ROW_TILE,
    SMEM_ALIGN,
    STAGE_BYTES,
    cta_tiles,
    scan_geometry,
    top2_scan,
    top2_scan_reference,
)


def _inputs(storage, rs, d, nq, metric, seed):
    """Shard operands as both exact scans build them (unit-norm rows)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((rs, d)).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    x[rs // 3 : rs // 3 + 4] = x[:4]  # exact duplicates: tie order
    q = rng.standard_normal((nq, d)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    dead = rng.random(rs) < 0.05
    add = np.where(dead, NEG, 0.0).astype(np.float32)
    if metric == "l2":
        add = add - np.sum(x * x, axis=1)
    if storage == "int8":
        sc = np.maximum(np.abs(x).max(axis=1), 1e-12) / 127.0
        vecs = np.clip(np.rint(x / sc[:, None]), -127, 127).astype(np.int8)
        mult = sc.astype(np.float32)
        qs = np.maximum(np.abs(q).max(axis=1), 1e-12) / 127.0
        qq = np.clip(np.rint(q / qs[:, None]), -127, 127).astype(np.float32)
        qsc = qs.astype(np.float32)
    else:
        vecs = x
        mult = np.ones(rs, np.float32)
        qq, qsc = q, np.ones(nq, np.float32)
    if metric == "l2":
        mult = (2.0 * mult).astype(np.float32)
    return vecs, mult, add.astype(np.float32), qq, qsc


def _jax(storage, vecs, mult, add, qq, qsc):
    v = jnp.asarray(vecs)
    if storage == "bfloat16":
        v = v.astype(jnp.bfloat16)
    bm, br = top2_scan_shard(
        v, jnp.asarray(mult)[None, :], jnp.asarray(add)[None, :],
        jnp.asarray(qq).astype(jnp.bfloat16), jnp.asarray(qsc)[:, None],
        interpret=True,
    )
    return np.asarray(bm), np.asarray(br)


def _torch(storage, vecs, mult, add, qq, qsc, device="cpu"):
    v = torch.from_numpy(vecs)
    if storage == "bfloat16":
        v = v.to(torch.bfloat16)
    q_t = torch.from_numpy(qq)
    q_t = q_t.to(torch.int8) if storage == "int8" else q_t.to(torch.bfloat16)
    args = [v, torch.from_numpy(mult), torch.from_numpy(add), q_t,
            torch.from_numpy(qsc)]
    return [a.to(device) for a in args]


@pytest.mark.parametrize("storage", ["int8", "bfloat16", "float32"])
@pytest.mark.parametrize("metric", ["ip", "l2"])
@pytest.mark.parametrize("rs,d,nq", [(300, 128, 5), (1000, 256, 8)])
def test_reference_matches_pallas_interpret(storage, metric, rs, d, nq):
    ops = _inputs(storage, rs, d, nq, metric, seed=rs + d)
    jm, jr = _jax(storage, *ops)
    tm, tr = top2_scan_reference(*_torch(storage, *ops))
    tm, tr = tm.numpy(), tr.numpy()
    # JAX tiles rows by pick_tiles(); below 4096 rows its block count is
    # ceil(Rs/128), the port's layout
    assert jm.shape == tm.shape == (nq, 2 * (-(-rs // 128)))
    if storage == "int8":
        np.testing.assert_array_equal(tr, jr)
        np.testing.assert_allclose(tm, jm, rtol=0, atol=1e-6)
    else:
        np.testing.assert_allclose(tm, jm, rtol=1e-5, atol=1e-6)
        nb = tm.shape[1] // 2
        gap = np.abs(jm[:, :nb] - jm[:, nb:])
        clear = np.concatenate([gap, gap], axis=1) > 1e-4
        np.testing.assert_array_equal(tr[clear], jr[clear])


def test_dead_block_emits_lane_zero_twice():
    """An all-sentinel block emits (-3e38, block base) in both slots, as the
    Pallas kernel's _top2_lanes does; a block with one live row puts the
    sentinel's lowest lane second."""
    storage, rs, d, nq = "int8", 384, 128, 3
    vecs, mult, add, qq, qsc = _inputs(storage, rs, d, nq, "ip", seed=3)
    add[128:256] = NEG  # block 1 dead
    add[256:384] = NEG
    add[300] = 0.0  # block 2: one live row
    jm, jr = _jax(storage, vecs, mult, add, qq, qsc)
    tm, tr = top2_scan_reference(*_torch(storage, vecs, mult, add, qq, qsc))
    np.testing.assert_array_equal(tr.numpy(), jr)
    np.testing.assert_array_equal(tm.numpy(), jm)
    nb = 3
    assert (tr.numpy()[:, 1] == 128).all() and (tr.numpy()[:, nb + 1] == 128).all()
    assert (tr.numpy()[:, 2] == 300).all() and (tr.numpy()[:, nb + 2] == 256).all()


def test_wrapper_runs_plain_version_on_cpu_without_launching():
    ops = _torch("int8", *_inputs("int8", 200, 128, 4, "ip", seed=5))
    before = top2_scan.launches
    bm, br = top2_scan(*ops)
    rm, rr = top2_scan_reference(*ops)
    assert torch.equal(bm, rm) and torch.equal(br, rr)
    assert top2_scan.launches == before


def test_wrapper_rejects_bad_operands():
    vecs, mult, add, qq, qsc = _torch("int8", *_inputs("int8", 200, 128, 4, "ip", 6))
    with pytest.raises(ValueError, match="dim % 128"):
        top2_scan(vecs[:, :64], mult, add, qq[:, :64], qsc)
    with pytest.raises(TypeError, match="qq must be"):
        top2_scan(vecs, mult, add, qq.to(torch.bfloat16), qsc)
    with pytest.raises(TypeError, match="mult must hold"):
        top2_scan(vecs, mult[:10], add, qq, qsc)


@pytest.mark.parametrize("storage", ["int8", "bfloat16"])
def test_reference_matches_pallas_interpret_at_tile_edges(storage):
    """The int8 kernel scores 256-row tiles of two 128-row blocks: exact
    duplicates straddling the block boundary inside a tile (rows 124-131),
    a tie inside block 0, an all-dead block opening the second tile and
    another closing the third. Plain version and Pallas agree exactly."""
    rs, d, nq = 700, 128, 6
    vecs, mult, add, qq, qsc = _inputs(storage, rs, d, nq, "ip", seed=11)
    vecs[128:132] = vecs[124:128]
    mult[128:132] = mult[124:128]
    vecs[5] = vecs[77]
    mult[5] = mult[77]
    add[124:132] = 0.0
    add[256:384] = NEG  # block 2: first block of tile 1
    add[640:700] = NEG  # block 5: second block of tile 2, ragged
    jm, jr = _jax(storage, vecs, mult, add, qq, qsc)
    tm, tr = top2_scan_reference(*_torch(storage, vecs, mult, add, qq, qsc))
    np.testing.assert_array_equal(tr.numpy(), jr)
    if storage == "int8":
        np.testing.assert_array_equal(tm.numpy(), jm)
    else:
        np.testing.assert_allclose(tm.numpy(), jm, rtol=1e-5, atol=1e-6)
    nb = 6
    for blk in (2, 5):  # dead blocks: lane 0 in both slots
        assert (tr.numpy()[:, blk] == 128 * blk).all()
        assert (tr.numpy()[:, nb + blk] == 128 * blk).all()


@pytest.mark.parametrize("storage", ["int8", "bfloat16", "float32"])
@pytest.mark.parametrize("d", [128, 384, 1024, 3072])
@pytest.mark.parametrize("nq", [1, 8, 65, 512, 1000])
def test_launch_geometry_fits_and_covers_every_tile_once(d, nq, storage):
    for rs, sms in ((181, 132), (70001, 132), (5000, 4)):
        geom = scan_geometry(rs, d, nq, sms, storage)
        assert 2 <= geom.stages
        assert geom.raw_stages == (RAW_STAGES if storage == "float32" else 0)
        assert geom.smem_bytes == (SMEM_ALIGN + geom.stages * STAGE_BYTES
                                   + geom.raw_stages * RAW_STAGE_BYTES
                                   + EPILOGUE_BYTES + BARRIER_BYTES)
        assert geom.smem_bytes <= 232_448
        # a stage holds 128 int8 or 64 bf16 values of depth a row
        assert geom.depth_chunks == d // (128 if storage == "int8" else 64)
        assert geom.n_row_tiles == -(-rs // ROW_TILE)
        assert geom.n_query_tiles == -(-nq // QUERY_TILE)
        assert 1 <= geom.grid == min(sms, geom.work_items)
        assert geom.turns == (storage != "float32")
        assert geom.shared_rows == (not geom.turns or geom.depth_chunks <= geom.stages)
        seen = [tile for cta in range(geom.grid) for tile in cta_tiles(geom, cta)]
        want = [(rt, qt) for rt in range(geom.n_row_tiles)
                for qt in range(geom.n_query_tiles)]
        assert sorted(seen) == want  # every tile exactly once


@pytest.mark.parametrize("storage", ["int8", "bfloat16", "float32"])
def test_no_geometry_shares_rows_past_the_ring(storage):
    """With turns, both consumers read a shared row chunk, the second only
    after the first has read the item's whole depth: sharing is only
    offered where that depth fits in the ring, or the ring deadlocks. f32
    rows are read by both consumers together, which shares at any depth."""
    shared = []
    for d in range(128, 4096 + 1, 128):
        geom = scan_geometry(70001, d, 512, 132, storage)
        if geom.turns:
            assert geom.shared_rows == (geom.depth_chunks <= geom.stages)
        if geom.shared_rows:
            shared.append(d)
    limit = {"int8": 512, "bfloat16": 256, "float32": 4096}[storage]
    assert shared == list(range(128, limit + 1, 128))


def test_geometry_constants_match_the_source():
    """The constants scan_geometry mirrors, read from csrc/top2_scan.cu."""
    import re
    from pathlib import Path

    from semcode_tpu_torch.ops import scan_top2

    src = (Path(scan_top2.__file__).parent / "csrc" / "top2_scan.cu").read_text()
    const = {m.group(1): int(m.group(2))
             for m in re.finditer(r"constexpr int (k\w+) = (\d+);", src)}
    assert const["kRowTile"] == ROW_TILE and const["kQueryTile"] == QUERY_TILE
    assert const["kChunk"] == DEPTH_CHUNK
    assert const["kRawStages"] == RAW_STAGES
    assert const["kEpiSlots"] * const["kRowTile"] * 8 == EPILOGUE_BYTES
    assert const["kBarrierBytes"] == BARRIER_BYTES
    assert const["kSmemAlign"] == SMEM_ALIGN and const["kSmemLimit"] == 232_448


def test_launch_geometry_rejects_what_the_kernel_cannot_run():
    for args in ((0, 128, 8, 132), (100, 96, 8, 132), (100, 128, 0, 132),
                 (100, 128, 8, 0), (100, 128, 8, 132, "float16")):
        with pytest.raises(ValueError, match="no top2_scan geometry"):
            scan_geometry(*args)
